"""Gaussian parameters of one class and their activation: port of
bilateral_driving_tpu/core/gaussians.py without flax.

A class keeps its parameters in a fixed-capacity dict of tensors plus a
liveness mask (dead slots render with zero opacity):
  means (C, 3), log_scales (C, 3), quats (C, 4) wxyz, logit_opacities
  (C, 1), sh_dc (C, 1, 3), sh_rest (C, K-1, 3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import sh as sh_lib
from .transforms import quat_normalize


class Gaussians(NamedTuple):
    """Activated world-space Gaussians of one class (static capacity)."""
    means: torch.Tensor        # (C, 3)
    scales: torch.Tensor       # (C, 3)
    quats: torch.Tensor        # (C, 4) unit
    opacities: torch.Tensor    # (C,), 0 for dead or invalid slots
    rgbs: torch.Tensor         # (C, 3)


def sh_colors(means, sh_dc, sh_rest, cam_origin, step: int,
              sh_degree_interval: int, max_degree: int) -> torch.Tensor:
    """View-dependent colour shared by every class: the active degree
    ramps with the step, then clamp(sh + 0.5, 0, 1)."""
    if max_degree == 0:
        return torch.sigmoid(sh_dc[:, 0, :])
    viewdirs = means - cam_origin[None, :]
    degree = min(step // sh_degree_interval, max_degree)
    coeffs = torch.cat([sh_dc, sh_rest], dim=1)
    rgbs = sh_lib.eval_sh(coeffs, viewdirs, degree, max_degree=max_degree)
    return torch.clamp(rgbs + 0.5, 0.0, 1.0)


def get_gaussians(params, mask, cam_origin, step: int,
                  sh_degree_interval: int, sh_degree: int) -> Gaussians:
    """Activate one class's world-space parameters for a camera."""
    means = params["means"]
    return Gaussians(
        means, torch.exp(params["log_scales"]),
        quat_normalize(params["quats"]),
        torch.sigmoid(params["logit_opacities"][:, 0]) * mask,
        sh_colors(means, params["sh_dc"], params["sh_rest"], cam_origin,
                  step, sh_degree_interval, sh_degree))
