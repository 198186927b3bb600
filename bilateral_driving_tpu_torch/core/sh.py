"""Real spherical-harmonics colour evaluation (degrees 0..3): port of
bilateral_driving_tpu/core/sh.py.

Coefficients are (N, K, 3) with K = (deg+1)^2 bases; bases above the active
degree are masked to zero so the shapes stay fixed while the degree ramps.
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    """The colour of a DC coefficient (inverse of rgb_to_sh)."""
    return sh * C0 + 0.5


def eval_sh_bases(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit directions -> (..., (degree+1)^2) basis values."""
    if not 0 <= degree <= 3:
        raise ValueError(f"SH degree must be in [0,3], got {degree}")
    out = [torch.full(dirs.shape[:-1], C0, dtype=dirs.dtype,
                      device=dirs.device)]
    if degree >= 1:
        x, y, z = dirs.unbind(-1)
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(coeffs: torch.Tensor, dirs: torch.Tensor, active_degree: int,
            max_degree: int = 3) -> torch.Tensor:
    """(..., 3) raw SH colours (callers add 0.5 and clamp); dirs are
    normalized here, safely at 0."""
    dirs = dirs * torch.rsqrt(torch.clamp(
        torch.sum(dirs * dirs, dim=-1, keepdim=True), min=1e-16))
    basis = eval_sh_bases(max_degree, dirs)
    k = basis.shape[-1]
    base_degrees = torch.tensor(
        [d for d in range(max_degree + 1) for _ in range(2 * d + 1)][:k],
        device=dirs.device)
    basis = basis * (base_degrees <= active_degree).to(basis.dtype)
    return torch.einsum("...k,...kc->...c", basis, coeffs)
