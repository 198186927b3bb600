"""Rotation math on tensors: port of bilateral_driving_tpu/core/transforms.py
(the functions the render path uses).

Quaternions are (w, x, y, z). Every function broadcasts over leading batch
dimensions and stays finite at the origin, in both passes.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True,
              eps: float = _EPS) -> torch.Tensor:
    """L2 norm with a finite gradient at x = 0: the squared norm is clamped
    before the sqrt, so below eps the gradient is exactly 0 (a clamp after
    `norm` routes 0 * NaN into the backward)."""
    sq = torch.clamp(torch.sum(x * x, dim=dim, keepdim=keepdim),
                     min=eps * eps)
    return torch.sqrt(sq)


def safe_normalize(x: torch.Tensor, dim: int = -1,
                   eps: float = _EPS) -> torch.Tensor:
    """x / ||x|| with a finite gradient at x = 0 (see safe_norm)."""
    sq = torch.clamp(torch.sum(x * x, dim=dim, keepdim=True), min=eps * eps)
    return x * torch.rsqrt(sq)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions, safe at q = 0."""
    return safe_normalize(q)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: float) -> torch.Tensor:
    """Shortest-arc slerp between unit quaternions at scalar t, with a lerp
    for nearly parallel pairs."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(torch.clamp(dot, -1.0, 1.0),
                                     0.0, 1.0 - 1e-7))
    sin_theta = torch.clamp(torch.sin(theta), min=_EPS)
    slerped = (torch.sin((1.0 - t) * theta) / sin_theta * q0
               + torch.sin(t * theta) / sin_theta * q1)
    lerped = (1.0 - t) * q0 + t * q1
    return quat_normalize(torch.where(dot > 0.9995, lerped, slerped))
