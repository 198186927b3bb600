"""Static background Gaussians (vanilla): port of
bilateral_driving_tpu/scene/background.py (`gaussians`, and `reg_loss` with
the flagship's sharp-shape term)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G


class BackgroundConfig(NamedTuple):
    sh_degree: int = 3
    sh_degree_interval: int = 1000


def gaussians(params, mask, cam_origin, step: int,
              cfg: BackgroundConfig = BackgroundConfig()) -> G.Gaussians:
    return G.get_gaussians(params, mask, cam_origin, step,
                           cfg.sh_degree_interval, cfg.sh_degree)


def reg_loss(params, mask, step: int, reg_cfg: dict) -> dict:
    """Shape regularisers of the live points; the YAMLs configure
    `sharp_shape_reg` (the max / min scale ratio past max_gauss_ratio,
    every step_interval steps) and, for PVG, `velocity_reg`, which the
    trainer computes (scene/pvg.velocity_reg_loss) and this passes by."""
    unported = set(reg_cfg) - {"sharp_shape_reg", "velocity_reg"}
    if unported:
        raise NotImplementedError(
            f"background regularisers {sorted(unported)} are not ported "
            "yet: the loss-variants slice")
    losses = {}
    n_alive = torch.clamp(torch.sum(mask), min=1.0)
    scaling = torch.exp(params["log_scales"])
    sharp = reg_cfg.get("sharp_shape_reg")
    if sharp is not None:
        ratio = torch.amax(scaling, -1) / torch.clamp(
            torch.amin(scaling, -1), min=1e-8)
        r = torch.clamp(ratio, min=sharp["max_gauss_ratio"]) \
            - sharp["max_gauss_ratio"]
        apply = step % sharp.get("step_interval", 10) == 0
        losses["sharp_shape_reg"] = (
            torch.sum(r * mask) / n_alive * sharp["w"] if apply
            else torch.zeros((), device=mask.device))
    return losses
