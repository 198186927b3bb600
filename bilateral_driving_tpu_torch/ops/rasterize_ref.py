"""Dense all-pairs rasterizer, O(N H W): port of
bilateral_driving_tpu/ops/rasterize_ref.py. A test oracle for tiny scenes
only; the render path never calls it (at 1M Gaussians x 160k pixels it is out
of reach).

Same compositing semantics as the tiled path: alpha formula, 0.999 clamp,
1/255 gate and the per-Gaussian tile-span support, but exact depth order
and no early stop.
"""
from __future__ import annotations

import torch

from .binning import TILE

ALPHA_THRESH = 1.0 / 255.0
MAX_ALPHA = 0.999


def rasterize_reference(means2d, conics, depths, radii, valid, opacities,
                        colors, width: int, height: int):
    """Returns (accum (H, W, C), alpha (H, W)); colors is (N, C)."""
    inf = torch.full_like(depths, float("inf"))
    order = torch.argsort(torch.where(valid, depths, inf), stable=True)
    means2d, conics, radii = means2d[order], conics[order], radii[order]
    valid, opacities, colors = valid[order], opacities[order], colors[order]
    dev = means2d.device

    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
    dx = px[None] - means2d[:, 0, None, None]          # (N, H, W)
    dy = py[None] - means2d[:, 1, None, None]
    a = conics[:, 0, None, None]
    b = conics[:, 1, None, None]
    c = conics[:, 2, None, None]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = torch.clamp(opacities[:, None, None] * torch.exp(-sigma),
                        max=MAX_ALPHA)

    r = radii.float()
    tx0 = torch.floor((means2d[:, 0] - r) / TILE)
    tx1 = torch.ceil((means2d[:, 0] + r) / TILE)
    ty0 = torch.floor((means2d[:, 1] - r) / TILE)
    ty1 = torch.ceil((means2d[:, 1] + r) / TILE)
    ptx = torch.floor((px - 0.5) / TILE)
    pty = torch.floor((py - 0.5) / TILE)
    in_span = ((ptx[None] >= tx0[:, None, None])
               & (ptx[None] < tx1[:, None, None])
               & (pty[None] >= ty0[:, None, None])
               & (pty[None] < ty1[:, None, None]))
    live = in_span & valid[:, None, None] & (radii[:, None, None] > 0)
    alpha = torch.where(live & (alpha >= ALPHA_THRESH), alpha,
                        torch.zeros_like(alpha))

    trans = torch.cumprod(1.0 - alpha, dim=0)
    trans_excl = torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)
    w = alpha * trans_excl
    accum = torch.einsum("nhw,nc->hwc", w, colors)
    return accum, torch.sum(w, dim=0)
