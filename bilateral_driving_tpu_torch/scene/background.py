"""Static background Gaussians (vanilla): port of
bilateral_driving_tpu/scene/background.py (`gaussians` and `reg_loss`)."""
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


def reg_loss(params, mask, step: int, reg_cfg: dict,
             cur_radii: torch.Tensor | None = None) -> dict:
    """Shape and opacity regularisers of the live points (compute_reg_loss
    of the reference's vanilla.py): `sharp_shape_reg` (the max / min scale
    ratio past max_gauss_ratio, every step_interval steps), `flatten` (the
    least scale), `sparse_reg` (the opacity entropy of the points this
    step's render saw, `cur_radii` > 0; left out without radii) and
    `max_s_square_reg` (the squared largest scale), each weighted by its
    `w`. PVG's `velocity_reg` is the trainer's (scene/pvg.velocity_reg_loss)
    and passes by here, as any other key does."""
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
    flatten = reg_cfg.get("flatten")
    if flatten is not None:
        min_scale = torch.clamp(torch.amin(scaling, dim=1), 0.0, 30.0)
        losses["flatten"] = (torch.sum(torch.abs(min_scale) * mask)
                             / n_alive * flatten["w"])
    sparse = reg_cfg.get("sparse_reg")
    if sparse is not None and cur_radii is not None:
        vis = (cur_radii > 0) & (mask > 0)
        nvis = torch.clamp(torch.sum(vis), min=1.0)
        op = torch.clamp(torch.sigmoid(params["logit_opacities"][:, 0]),
                         1e-6, 1.0 - 1e-6)
        ent = -(op * torch.log(op) + (1 - op) * torch.log(1 - op))
        losses["sparse_reg"] = torch.sum(ent * vis) / nvis * sparse["w"]
    max_s = reg_cfg.get("max_s_square_reg")
    if max_s is not None:
        losses["max_s_square"] = (
            torch.sum(torch.amax(scaling, dim=1) ** 2 * mask) / n_alive
            * max_s["w"])
    return losses
