"""Bilateral-grid appearance: port of
bilateral_driving_tpu/models/bilateral.py.

Per-image grids of 3x4 colour affines, (N, 12, L, H, W), identity at init,
sliced trilinearly at (x, y, gray(rgb)) with `grid_sample` semantics
(align_corners=True, border padding). The single grid (16 x 16 x 8 by
default) is sliced at full resolution; each multi-scale level is sliced at
downsampled guidance, upsampled back to full size and applied in turn,
with an optional cycle-consistency loss (`inverse_loss`). The neural grids
hold zero-initialised feature grids whose slices a shared MLP head per
level maps to affines that the trainer applies residually; the CP-4D grid
is a rank-R factorisation over (x, y, z, gray) into four 1-D factor banks.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.indexing import take_rows
from . import encoders

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
        return take_rows(flat, (zi * H + yi) * W + xi) * w[:, None]

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


def _linear_weights(n_in: int, n_out: int, device,
                    dtype=torch.float32) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize(method="linear")` along one
    axis: a triangle kernel widened by the factor when downsampling
    (antialiasing), normalized per output sample."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=dtype, device=device)
              + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=dtype, device=device)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(dtype).eps
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
                           _linear_weights(H, h, img.device, img.dtype))
    if w != W:
        out = torch.einsum("ywc,wx->yxc", out,
                           _linear_weights(W, w, img.device, img.dtype))
    return out


def init_bilateral(num_images: int, grid_x: int = 16, grid_y: int = 16,
                   grid_w: int = 8, device="cuda"):
    return {"grids": init_grid(num_images, grid_x, grid_y, grid_w, device)}


def bilateral_affines(params, rgb: torch.Tensor, img_idx: int,
                      neighbor_idx: Sequence[int] | None = None
                      ) -> torch.Tensor:
    """(H, W, 3, 4) affines of one image's single grid; with `neighbor_idx`
    (test views) the mean of the affines sliced from the neighbouring
    training images' grids."""
    h, w, _ = rgb.shape
    xy = uv_grid(h, w, rgb.dtype, rgb.device)
    grids = params["grids"]
    if neighbor_idx is None:
        return slice_affines(grids[img_idx], xy, rgb)
    return torch.stack([slice_affines(grids[int(i)], xy, rgb)
                        for i in neighbor_idx]).mean(dim=0)


def bilateral_tv_loss(params) -> torch.Tensor:
    return total_variation_loss(params["grids"])


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


def total_variation_loss(grids: torch.Tensor) -> torch.Tensor:
    """Mean squared neighbour difference along each spatial axis of
    grids (B, C, ...), summed over the axes and averaged over B."""
    b = grids.shape[0]
    tv = torch.zeros((), dtype=grids.dtype, device=grids.device)
    for axis in range(2, grids.dim()):
        if grids.shape[axis] < 2:
            continue
        d = torch.diff(grids, dim=axis)
        tv = tv + torch.sum(d * d) / d[0].numel()
    return tv / b


def multiscale_tv_loss(params, grid_sizes: Sequence[Sequence[int]] =
                       DEFAULT_MS_GRID) -> torch.Tensor:
    """Per-level TV weighted 0.5 sqrt(X Y W), of the grids of a pyramid,
    multi-scale or neural (the JAX package's multiscale_neural_tv_loss)."""
    loss = 0.0
    for level, (gx, gy, gw) in zip(params["levels"], grid_sizes):
        loss = loss + total_variation_loss(level["grids"]) * (
            0.5 * (gx * gy * gw) ** 0.5)
    return loss


def inverse_loss(mats_list, gt_rgb: torch.Tensor,
                 pre_affine_rgb: torch.Tensor) -> torch.Tensor:
    """Cycle consistency: invert the composed homogeneous affine of the
    levels, apply it to the ground truth, L1 against the render before
    the affines."""
    h, w = gt_rgb.shape[:2]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=gt_rgb.dtype,
                          device=gt_rgb.device).expand(h, w, 1, 4)
    mat = torch.eye(4, dtype=gt_rgb.dtype, device=gt_rgb.device).expand(
        h, w, 4, 4)
    for mats in mats_list:
        mat = torch.cat([mats, bottom], dim=-2) @ mat
    inv = torch.linalg.inv(mat)
    gt_t = apply_affine(inv[..., :3, :], gt_rgb)
    return torch.mean(torch.abs(gt_t - pre_affine_rgb))


def _guidance(rgb: torch.Tensor) -> torch.Tensor:
    """(h, w, 3) slice coordinates (x, y, gray) in [-1, 1] of an image."""
    h, w, _ = rgb.shape
    xy = uv_grid(h, w, rgb.dtype, rgb.device)
    return torch.cat([xy * 2.0 - 1.0, rgb_to_gray(rgb)[..., None]], dim=-1)


def _features(grids: torch.Tensor, coords: torch.Tensor, img_idx: int,
              neighbor_idx: Sequence[int] | None) -> torch.Tensor:
    """Image img_idx's grid sliced at coords, or the mean of the
    neighbours' slices."""
    if neighbor_idx is None:
        return grid_sample_3d(grids[img_idx], coords)
    return torch.stack([grid_sample_3d(grids[int(i)], coords)
                        for i in neighbor_idx]).mean(dim=0)


def init_neural_bilateral(generator: torch.Generator, num_images: int,
                          grid_x: int, grid_y: int, grid_w: int,
                          feature_dim: int, hidden_dim: int, device="cuda"):
    """Zero feature grids (N, F, L, H, W) and a shared MLP head mapping a
    sliced feature to a 3x4 affine, its last layer zero."""
    return {
        "grids": torch.zeros((num_images, feature_dim, grid_w, grid_y,
                              grid_x), device=device),
        "head": encoders.mlp_init(generator, feature_dim, 12, 2, hidden_dim,
                                  zero_init_last=True, device=device),
    }


def neural_bilateral_affines(params, rgb: torch.Tensor, img_idx: int,
                             neighbor_idx: Sequence[int] | None = None
                             ) -> torch.Tensor:
    """(H, W, 3, 4) residual affines from the sliced features through the
    head; on test views (`neighbor_idx`) the neighbours' features are
    averaged."""
    h, w, _ = rgb.shape
    feats = _features(params["grids"], _guidance(rgb), img_idx,
                      neighbor_idx)
    return encoders.mlp_apply(params["head"], feats).reshape(h, w, 3, 4)


def init_multiscale_neural(generator: torch.Generator, num_images: int,
                           grid_sizes: Sequence[Sequence[int]] =
                           DEFAULT_MS_GRID, feature_dim: int = 8,
                           hidden_dim: int = 64, device="cuda"):
    """A pyramid of zero feature grids, each level with its own head."""
    return {"levels": [
        {"grids": torch.zeros((num_images, feature_dim, gw, gy, gx),
                              device=device),
         "head": encoders.mlp_init(generator, feature_dim, 12, 2, hidden_dim,
                                   zero_init_last=True, device=device)}
        for gx, gy, gw in grid_sizes]}


def multiscale_neural_affines(params, rgb: torch.Tensor, img_idx: int,
                              guidance_factor: Sequence[int] =
                              DEFAULT_GUIDANCE_FACTOR,
                              neighbor_idx: Sequence[int] | None = None
                              ) -> torch.Tensor:
    """(H, W, 3, 4) residual affines: the sum over levels of each level's
    head applied to its slice at downsampled guidance, upsampled to full
    size."""
    h, w, _ = rgb.shape
    total = torch.zeros((h, w, 12), dtype=rgb.dtype, device=rgb.device)
    for level, factor in zip(params["levels"], guidance_factor):
        hd, wd = h // factor, w // factor
        rgb_low = resize_bilinear(rgb, hd, wd) if factor != 1 else rgb
        feats = _features(level["grids"], _guidance(rgb_low), img_idx,
                          neighbor_idx)
        mats = encoders.mlp_apply(level["head"], feats)
        if (hd, wd) != (h, w):
            mats = resize_bilinear(mats, h, w)
        total = total + mats
    return total.reshape(h, w, 3, 4)


def init_cp4d(generator: torch.Generator, rank: int = 5, grid_x: int = 16,
              grid_y: int = 16, grid_z: int = 16, grid_w: int = 8,
              out_dim: int = 12, device="cuda"):
    """Four (rank, size, out_dim) factor banks whose rank-0 products are
    the identity affine everywhere (fx0 = fy0 = fz0 = 1, fw0 = identity);
    the other ranks start at 1e-3 noise."""
    def factor(size):
        f = torch.zeros((rank, size, out_dim))
        f[0] = 1.0
        f[1:] += 1e-3 * torch.randn((rank - 1, size, out_dim),
                                    generator=generator,
                                    device=generator.device).cpu()
        return f

    banks = {k: factor(n) for k, n in (("fx", grid_x), ("fy", grid_y),
                                       ("fz", grid_z), ("fw", grid_w))}
    banks["fw"][0] = torch.tensor([1.0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0])
    return {k: v.to(device) for k, v in banks.items()}


def _lerp_1d(bank: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """bank (R, S, D) sampled at coord (...,) in [-1, 1], align-corners,
    the lower index clamped at S - 2: (..., R, D)."""
    s = bank.shape[1]
    pix = torch.clamp((coord + 1.0) * 0.5 * (s - 1), 0.0, s - 1)
    i0 = torch.clamp(torch.floor(pix), 0, max(s - 2, 0)).to(torch.int64)
    w = (pix - i0.to(pix.dtype))[..., None, None]
    lo = torch.movedim(bank[:, i0], 0, -2)
    hi = torch.movedim(bank[:, torch.clamp(i0 + 1, 0, s - 1)], 0, -2)
    return lo * (1 - w) + hi * w


def cp4d_affines(params, xyz: torch.Tensor, rgb: torch.Tensor
                 ) -> torch.Tensor:
    """(..., 3, 4) affines at xyz (..., 3) in [-1, 1] and gray(rgb): the
    sum over ranks of the four factors' product."""
    vx = _lerp_1d(params["fx"], xyz[..., 0])
    vy = _lerp_1d(params["fy"], xyz[..., 1])
    vz = _lerp_1d(params["fz"], xyz[..., 2])
    vw = _lerp_1d(params["fw"], rgb_to_gray(rgb))
    mats = torch.sum(vx * vy * vz * vw, dim=-2)
    return mats.reshape(*xyz.shape[:-1], 3, 4)


def cp4d_tv_loss(params) -> torch.Tensor:
    """Mean squared neighbour difference along each bank's grid axis."""
    tv = 0.0
    for k in ("fx", "fy", "fz", "fw"):
        d = torch.diff(params[k], dim=1)
        tv = tv + torch.mean(d * d)
    return tv


def color_correct(img: torch.Tensor, ref: torch.Tensor, num_iters: int = 5,
                  eps: float = 0.5 / 255.0) -> torch.Tensor:
    """Per-channel quadratic least-squares colour matching of `img` to
    `ref` with outlier-aware refits (lib_bilagrid.py:56-122), as the
    colour-corrected eval uses it. Each fit is the minimum-norm solution
    through the pseudo-inverse, as jnp.linalg.lstsq takes it."""
    img_f = img.reshape(-1, 3)
    ref_f = ref.reshape(-1, 3)
    num_pix = img_f.shape[0]
    # quadratic expansion: [r, g, b, rg, rb, gb, r^2, g^2, b^2, 1]
    r, g, b = img_f[:, 0], img_f[:, 1], img_f[:, 2]
    A = torch.stack([r, g, b, r * g, r * b, g * b, r * r, g * g, b * b,
                     torch.ones(num_pix, dtype=img.dtype,
                                device=img.device)], dim=-1)
    out = []
    for c in range(3):
        y = ref_f[:, c]
        mask = torch.ones(num_pix, dtype=img.dtype, device=img.device)
        x = torch.zeros((A.shape[1],), dtype=img.dtype, device=img.device)
        for _ in range(num_iters):
            x = torch.linalg.pinv(A * mask[:, None]) @ (y * mask)
            pred = A @ x
            mask = ((pred >= -eps) & (pred <= 1.0 + eps)).to(img.dtype)
        out.append(torch.clamp(A @ x, 0.0, 1.0))
    return torch.stack(out, dim=-1).reshape(img.shape)
