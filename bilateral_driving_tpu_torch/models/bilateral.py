"""Multi-scale bilateral-grid appearance: port of the multi-scale path of
bilateral_driving_tpu/models/bilateral.py.

Per-image grids of 3x4 colour affines, (N, 12, L, H, W), identity at init,
sliced trilinearly at (x, y, gray(rgb)) with `grid_sample` semantics
(align_corners=True, border padding); each level is sliced at downsampled
guidance, upsampled back to full size and applied in turn.
"""
from __future__ import annotations

from typing import Sequence

import torch

RGB2GRAY = (0.299, 0.587, 0.114)      # BT601

DEFAULT_MS_GRID = ((2, 2, 1), (4, 4, 2), (8, 8, 4))
DEFAULT_GUIDANCE_FACTOR = (4, 4, 2)


def init_grid(num_images: int, grid_x: int, grid_y: int, grid_w: int,
              device="cuda") -> torch.Tensor:
    """(N, 12, L, H, W) identity-affine grids."""
    ident = torch.tensor([1.0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
                         device=device)
    return ident[None, :, None, None, None].expand(
        num_images, 12, grid_w, grid_y, grid_x).contiguous()


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Guidance in [-1, 1] for rgb in [0, 1]."""
    w = torch.tensor(RGB2GRAY, dtype=rgb.dtype, device=rgb.device)
    return (rgb @ w) * 2.0 - 1.0


def _sample_coords(coord: torch.Tensor, size: int):
    """align_corners=True + border padding: [-1, 1] -> index + lerp weight."""
    pix = torch.clamp((coord + 1.0) * 0.5 * (size - 1), 0.0, size - 1)
    i0 = torch.clamp(torch.floor(pix), 0, max(size - 2, 0)).to(torch.int64)
    i1 = torch.clamp(i0 + 1, 0, size - 1)
    return i0, i1, pix - i0.to(coord.dtype)


def grid_sample_3d(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of vol (C, D, H, W) at coords (..., 3) = (x, y, z) in
    [-1, 1]: x indexes W, y H, z D, like `F.grid_sample(mode='bilinear',
    align_corners=True, padding_mode='border')` on 5-D input. (..., C)."""
    C, D, H, W = vol.shape
    batch_shape = coords.shape[:-1]
    c = coords.reshape(-1, 3)
    x0, x1, wx = _sample_coords(c[:, 0], W)
    y0, y1, wy = _sample_coords(c[:, 1], H)
    z0, z1, wz = _sample_coords(c[:, 2], D)
    flat = vol.reshape(C, D * H * W).T                 # (cells, C)

    def corner(zi, yi, xi, w):
        return flat[(zi * H + yi) * W + xi] * w[:, None]

    out = (corner(z0, y0, x0, (1 - wz) * (1 - wy) * (1 - wx))
           + corner(z0, y0, x1, (1 - wz) * (1 - wy) * wx)
           + corner(z0, y1, x0, (1 - wz) * wy * (1 - wx))
           + corner(z0, y1, x1, (1 - wz) * wy * wx)
           + corner(z1, y0, x0, wz * (1 - wy) * (1 - wx))
           + corner(z1, y0, x1, wz * (1 - wy) * wx)
           + corner(z1, y1, x0, wz * wy * (1 - wx))
           + corner(z1, y1, x1, wz * wy * wx))
    return out.reshape(*batch_shape, C)


def slice_affines(grid: torch.Tensor, xy: torch.Tensor,
                  rgb: torch.Tensor) -> torch.Tensor:
    """Slice one image's grid (12, L, H, W) at xy in [0, 1] and gray(rgb):
    (..., 3, 4) affines."""
    coords = torch.cat([xy * 2.0 - 1.0, rgb_to_gray(rgb)[..., None]], dim=-1)
    mats = grid_sample_3d(grid, coords)
    return mats.reshape(*mats.shape[:-1], 3, 4)


def apply_affine(mats: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Colour affine transform: mats (..., 3, 4), rgb (..., 3)."""
    return (torch.einsum("...ij,...j->...i", mats[..., :3], rgb)
            + mats[..., 3])


def uv_grid(h: int, w: int, dtype=torch.float32, device="cuda"):
    """(h, w, 2) pixel xy in [0, 1] (linspace, like torch.linspace(0, 1))."""
    ys = torch.linspace(0.0, 1.0, h, dtype=dtype, device=device)
    xs = torch.linspace(0.0, 1.0, w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize(method="linear")` along one
    axis: a triangle kernel widened by the factor when downsampling
    (antialiasing), normalized per output sample."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(img, (h, w, C), "linear")` for (H, W, C): separable
    weights, antialiased when shrinking."""
    H, W = img.shape[-3], img.shape[-2]
    out = img
    if h != H:
        out = torch.einsum("hwc,hy->ywc", out,
                           _linear_weights(H, h, img.device))
    if w != W:
        out = torch.einsum("ywc,wx->yxc", out,
                           _linear_weights(W, w, img.device))
    return out


def init_multiscale(num_images: int,
                    grid_sizes: Sequence[Sequence[int]] = DEFAULT_MS_GRID,
                    device="cuda"):
    return {"levels": [{"grids": init_grid(num_images, gx, gy, gw, device)}
                       for gx, gy, gw in grid_sizes]}


def multiscale_affines(params, rgb: torch.Tensor, img_idx: int,
                       guidance_factor: Sequence[int] =
                       DEFAULT_GUIDANCE_FACTOR,
                       neighbor_idx: Sequence[int] | None = None) -> list:
    """Per-level full-size (H, W, 3, 4) affine maps. With `neighbor_idx`
    (test views) each level averages the affines sliced from the
    neighbouring training images' grids."""
    h, w, _ = rgb.shape
    mats_list = []
    for level, factor in zip(params["levels"], guidance_factor):
        hd, wd = h // factor, w // factor
        rgb_low = resize_bilinear(rgb, hd, wd) if factor != 1 else rgb
        xy = uv_grid(hd, wd, rgb.dtype, rgb.device)
        grids = level["grids"]
        if neighbor_idx is None:
            mats = slice_affines(grids[img_idx], xy, rgb_low)
        else:
            mats = torch.stack([slice_affines(grids[int(i)], xy, rgb_low)
                                for i in neighbor_idx]).mean(dim=0)
        if (hd, wd) != (h, w):
            mats = resize_bilinear(mats.reshape(hd, wd, 12), h, w).reshape(
                h, w, 3, 4)
        mats_list.append(mats)
    return mats_list


def compose_affines(mats_list, rgb: torch.Tensor) -> torch.Tensor:
    """Apply the levels' affines in turn."""
    out = rgb
    for mats in mats_list:
        out = apply_affine(mats, out)
    return out
