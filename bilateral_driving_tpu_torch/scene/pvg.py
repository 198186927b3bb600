"""Periodic Vibration Gaussians, the PVG background: port of
bilateral_driving_tpu/scene/pvg.py (reference
project/models/gaussians/pvg.py).

Per point a life peak `tau`, a temporal scale `beta` and a velocity:
  means(t) = mu + v * sin((t - tau) * 2 pi / T) / (2 pi / T)
  opacity(t) = o * exp(-0.5 (t - tau)^2 / beta^2)
The marginal-visibility filter (`get_marginal_t > 0.05`, pvg.py:391) is an
opacity mask rather than a gather, as in the JAX package. Temporal
smoothing (pvg.py:377-389) renders at a perturbed time t1 and adds
v * (t2 - t1).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import gaussians as G
from ..core.transforms import quat_normalize


class PVGConfig(NamedTuple):
    """Times (t, taus, cycle, betas) all live on the reference's scaled
    time axis: consecutive frames are `time_interval` (0.02) apart
    (pvg.py:46-47 train_time_scale), not normalized to [0, 1]; cycle_length
    0.2 and betas_init 0.1 are tuned for that spacing. Callers scale
    normalized times by time_interval * (num_frames - 1)."""
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    cycle: float = 0.2           # T, the vibration period (scaled time)
    marginal_thresh: float = 0.05


def init_extras(capacity: int, num_points: int, t_init=None,
                beta_init: float = 0.1, time_scale: float = 1.0,
                device="cuda"):
    """taus from each point's normalized observation time (or 0) scaled
    by `time_scale` (pvg.py:53), log betas, zero velocity (pvg
    create_from_pcd)."""
    taus = torch.zeros((capacity,), device=device)
    if t_init is not None:
        taus[:num_points] = t_init.to(device) * time_scale
    return {
        "taus": taus,
        # the reference stores log(sqrt(betas_init)) (pvg.py:55-56: betas
        # = sqrt(ones * betas_init); _betas = log(betas)): a life span of
        # sqrt(0.1) ~ 0.316 keeps every point visible across the clip at
        # init; without the sqrt the visibility window is 3.16x too narrow
        # and renders collapse within a few steps
        "log_betas": torch.full((capacity,), 0.5 * float(torch.log(
            torch.tensor(beta_init, dtype=torch.float32))), device=device),
        "velocity": torch.zeros((capacity, 3), device=device),
    }


def temporal_state(params, t, cfg: PVGConfig):
    betas = torch.exp(params["log_betas"])
    a = 2.0 * math.pi / cfg.cycle
    means = params["means"] + params["velocity"] * torch.sin(
        (t - params["taus"])[:, None] * a) / a
    marginal = torch.exp(-0.5 * (params["taus"] - t) ** 2 / betas ** 2)
    return means, marginal, betas


def effective_velocity(params, cfg: PVGConfig):
    """v * exp(-0.5 rho), rho = beta / T (pvg.py:86-89)."""
    rho = torch.exp(params["log_betas"]) / cfg.cycle
    return params["velocity"] * torch.exp(-0.5 * rho)[:, None]


def gaussians(params, mask, cam_origin, step: int, t,
              cfg: PVGConfig = PVGConfig(),
              smooth_delta_t=0.0) -> G.Gaussians:
    """t: the (possibly perturbed) scaled time; smooth_delta_t = t_train -
    t under temporal smoothing, else 0."""
    means, marginal, _ = temporal_state(params, t, cfg)
    means = means + effective_velocity(params, cfg) * smooth_delta_t
    visible = (marginal > cfg.marginal_thresh).to(marginal.dtype)
    opac = (torch.sigmoid(params["logit_opacities"][:, 0]) * marginal
            * visible * mask)
    scales = torch.exp(params["log_scales"])
    quats = quat_normalize(params["quats"])
    rgbs = G.sh_colors(means, params["sh_dc"], params["sh_rest"], cam_origin,
                       step, cfg.sh_degree_interval, cfg.sh_degree)
    return G.Gaussians(means, scales, quats, opac, rgbs)


def velocity_reg_loss(params, mask, cur_radii, w: float, cfg: PVGConfig):
    """Per-point velocity regularisation over the visible points
    (pvg.py:429-437)."""
    vis = ((cur_radii > 0) & (mask > 0)).to(params["velocity"].dtype)
    nvis = torch.clamp(torch.sum(vis), min=1.0)
    # a safe L2 norm: the velocity starts at exactly 0, where the norm's
    # gradient is not finite
    v = effective_velocity(params, cfg)
    vnorm = torch.sqrt(torch.sum(v * v, dim=-1) + 1e-12)
    return torch.sum(vnorm * vis) / nvis * w
