"""Bilinear cube-map sampling: port of the forward half of
bilateral_driving_tpu/ops/cubemap.py (`faces_uv`, `sample`). The texture
gradient (`splat_grad`, a TPU kernel) belongs to the training slice.
"""
from __future__ import annotations

import torch


def faces_uv(dirs: torch.Tensor):
    """OpenGL cube-map face id (0:+x 1:-x 2:+y 3:-y 4:+z 5:-z) and (u, v)
    in [-1, 1] for directions (..., 3)."""
    x, y, z = dirs.unbind(-1)
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    eps = 1e-9
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    def pick(cond, a, b):
        return torch.where(cond, torch.as_tensor(a, device=dirs.device),
                           torch.as_tensor(b, device=dirs.device))

    face = torch.where(is_x, pick(x >= 0, 0, 1),
                       torch.where(is_y, pick(y >= 0, 2, 3),
                                   pick(z >= 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)) + eps
    u = torch.where(is_x, torch.where(x >= 0, -z, z),
                    torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    v = torch.where(is_x, -y,
                    torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    return face.to(torch.int32), u / ma, v / ma


def _corner_coords(u, v, res: int):
    pix_u = torch.clamp((u * 0.5 + 0.5) * res - 0.5, 0.0, res - 1)
    pix_v = torch.clamp((v * 0.5 + 0.5) * res - 0.5, 0.0, res - 1)
    u0 = torch.clamp(torch.floor(pix_u), 0, res - 2).to(torch.int64)
    v0 = torch.clamp(torch.floor(pix_v), 0, res - 2).to(torch.int64)
    return u0, v0, pix_u - u0, pix_v - v0


def sample(base: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear cube lookup with per-face border clamping; base
    (6, R, R, C), dirs (..., 3), normalized here."""
    res = base.shape[1]
    c = base.shape[-1]
    d = dirs * torch.rsqrt(torch.clamp(
        torch.sum(dirs * dirs, dim=-1, keepdim=True), min=1e-18))
    face, u, v = faces_uv(d)
    u0, v0, wu, wv = _corner_coords(u, v, res)
    flat = base.reshape(6 * res * res, c)
    face = face.to(torch.int64)

    def corner(vi, ui):
        return flat[(face * res + vi) * res + ui]

    wu = wu[..., None]
    wv = wv[..., None]
    return (corner(v0, u0) * (1 - wv) * (1 - wu)
            + corner(v0, u0 + 1) * (1 - wv) * wu
            + corner(v0 + 1, u0) * wv * (1 - wu)
            + corner(v0 + 1, u0 + 1) * wv * wu)
