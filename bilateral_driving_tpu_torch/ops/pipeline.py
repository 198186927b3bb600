"""Differentiable tiled rasterization pipeline: port of
bilateral_driving_tpu/ops/pipeline.py.

projection -> opacity-aware tile spans -> entry offsets -> expansion kernel
(per-entry sort key, Gaussian id and features) -> stable sort by key ->
per-tile ranges -> compositing kernel. The JAX package sorts with
`lax.sort(num_keys=2)` on (key, gid); entries are produced in Gaussian-id
order, so a stable sort on the key alone gives the same order.

Projection is plain PyTorch and autograd differentiates it. From the
per-Gaussian feature rows on (x, y, a, b, c, logop, r, g, b, depth, rows
4-13 of the table the kernels read), `_Rasterize` (a
torch.autograd.Function) carries the gradient: the compositing backward
kernel gives per-entry gradients in the sorted order, the saved sort
permutation puts them back in expansion (Gaussian-major) order, and the
segment-sum kernel adds each Gaussian's entries. The JAX package re-sorts
by Gaussian id for the same grouping.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import binning, expand_cuda, projection, rasterize_cuda, segsum_cuda
from .binning import CHUNK, TILE, num_tiles
from .expand_cuda import FEAT0

CAP_BUCKET = 2 ** 17


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    near_plane: float = 0.01
    far_plane: float = 1e10
    radius_clip: float = 0.0
    antialiased: bool = False
    isect_capacity: int = 2 ** 21
    # opacity-aware effective-radius span tightening (output-exact under
    # the compositing 1/255 alpha gate; see rasterize())
    tight_radius: bool = True
    # rendering a band of a larger image (tile bands): `fov_extent`, the
    # full image's (width, height), makes the projection clamp the
    # Jacobian with the full image's field of view and the sort key split
    # its bits between tile and depth as the full image's does (near-equal
    # depths composite in the full image's order) and the cull keep every
    # Gaussian of the full image (radii and valid are the full image's;
    # the spans clip them to the band); None: the render's own extent.
    # `row_offset`: the band's first row, a multiple of TILE
    # (projection.project; the band's entries keep the whole render's
    # place within a compositing chunk, see rasterize())
    fov_extent: tuple | None = None
    row_offset: int = 0


def _project(means, quats, scales, viewmat, K, width: int, height: int,
             cfg: RasterizeConfig) -> projection.Projected:
    """projection.project with cfg's options; a band (fov_extent set)
    culls against the full image's rows."""
    return projection.project(
        means, quats, scales, viewmat, K, width, height,
        near_plane=cfg.near_plane, far_plane=cfg.far_plane,
        radius_clip=cfg.radius_clip, antialiased=cfg.antialiased,
        fov_extent=cfg.fov_extent, row_offset=cfg.row_offset,
        cull_rows=(None if cfg.fov_extent is None else
                   (-cfg.row_offset, cfg.fov_extent[1] - cfg.row_offset)))


def probe_num_isects(means, quats, scales, viewmat, K, width: int,
                     height: int, cfg: RasterizeConfig | None = None) -> int:
    """Projection + tile spans only, counting the scene's tile
    intersections for `autotune_capacity`."""
    proj = _project(means, quats, scales, viewmat, K, width, height,
                    cfg or RasterizeConfig())
    sp = binning.spans(proj.means2d, proj.radii, proj.valid, width, height)
    return int(torch.sum(sp.counts.long()))


def autotune_capacity(num_isects: int, margin: float = 1.35,
                      floor: int = CAP_BUCKET) -> int:
    """Intersection capacity from measured occupancy, in multiples of
    CAP_BUCKET so a changing scene rarely changes it."""
    want = max(int(num_isects * margin), floor)
    return -(-want // CAP_BUCKET) * CAP_BUCKET


class _Rasterize(torch.autograd.Function):
    """feature rows (10, N), an optional (cap, 2) screen-mean sink and
    span/id rows (6, N) -> (tiles (n_tiles, 5, 1024), sorted Gaussian ids).
    The feature rows and the sink are differentiable. `phase`, an optional
    0-d tensor in [0, CHUNK): the sorted entries go to the compositing
    kernels at columns phase.. of a buffer one chunk wider."""

    @staticmethod
    def forward(ctx, feat_rows, sink, phase, meta_rows, offsets, num_isects,
                cap: int, ntx: int, n_tiles: int, key_tiles: int, width: int,
                height: int, want_grad: bool):
        n = offsets.shape[0] - 1
        table_T = torch.cat([meta_rows[:FEAT0], feat_rows,
                             meta_rows[FEAT0:]])
        key, gid, feats = expand_cuda.expand_gather(
            table_T, offsets, num_isects, cap, ntx, key_tiles, n)
        key_s, perm = torch.sort(key, stable=True)
        gid_s = gid[perm]
        feats_s = feats[:, perm]
        if sink is not None:
            # the sink adds to the sorted entries' screen means (rows 0-1)
            feats_s[0:2] += sink.T
        starts, counts = binning.tile_ranges(
            binning.tiles_of_keys(key_s, key_tiles), num_isects, n_tiles,
            cap)
        if phase is not None:
            cols = torch.arange(cap, device=feats_s.device) + phase
            feats_s = feats_s.new_zeros((feats_s.shape[0], cap + CHUNK)) \
                .index_copy_(1, cols, feats_s)
            starts = starts + phase.to(torch.int32)
        ctx.mark_non_differentiable(gid_s)
        if not want_grad:
            return (rasterize_cuda.rasterize_fwd(
                feats_s, starts, counts, width, height), gid_s)
        out, n_live, ckpt_off, ckpt = rasterize_cuda.rasterize_fwd(
            feats_s, starts, counts, width, height, residuals=True)
        ctx.save_for_backward(feats_s, starts, counts, n_live, ckpt_off,
                              ckpt, perm, offsets, phase)
        ctx.dims = (width, height)
        ctx.has_sink = sink is not None
        return out, gid_s

    @staticmethod
    def backward(ctx, g_out, _g_gid):
        feats_s, starts, counts, n_live, ckpt_off, ckpt, perm, offsets, \
            phase = ctx.saved_tensors
        width, height = ctx.dims
        d_sorted = rasterize_cuda.rasterize_bwd(
            feats_s, starts, counts, n_live, ckpt_off, ckpt,
            g_out.contiguous(), width, height)
        if phase is not None:
            d_sorted = d_sorted.index_select(1, torch.arange(
                perm.shape[0], device=perm.device) + phase)
        # un-sort (the inverse of the forward's gather feats[:, perm]) into
        # Gaussian-major order, then one sum per Gaussian
        d_rows = torch.empty_like(d_sorted)
        d_rows[:, perm] = d_sorted
        # the sink's gradient: each sorted entry's screen-mean gradient
        d_sink = d_sorted[0:2].T if ctx.has_sink else None
        return (segsum_cuda.segment_sum(d_rows, offsets), d_sink) \
            + (None,) * 11


def rasterize(means, quats, scales, opacities, colors, viewmat, K,
              width: int, height: int,
              cfg: RasterizeConfig = RasterizeConfig(), means2d_dummy=None,
              mean2d_sink=None):
    """Tiled rasterization of N Gaussians into one camera, differentiable
    in every floating input.

    Args:
      means/quats/scales: (N,3), (N,4), (N,3) world-space geometry.
      opacities: (N,) in [0, 1]; colors: (N, 3) RGB after SH.
      viewmat: (4, 4) world -> camera; K: (3, 3).
      means2d_dummy: optional (N, 2) zeros added to the projected means;
        its gradient is the per-Gaussian screen-space gradient (the
        densification statistic).
      mean2d_sink: optional (isect_capacity, 2) zeros added to the sorted
        entries' screen means; its gradient is the per-intersection
        screen-space gradient (absgrad_from_sink's input).
    Returns:
      dict with rgb (H, W, 3), depth (H, W, 1) expected depth, alpha
      (H, W, 1), and info {means2d, depths, radii, valid, num_isects,
      overflow, gauss_ids}. Past `isect_capacity` the entries are
      truncated and info["overflow"] is True.
    """
    n = means.shape[0]
    cap = cfg.isect_capacity
    proj = _project(means, quats, scales, viewmat, K, width, height, cfg)
    means2d = proj.means2d
    if means2d_dummy is not None:
        means2d = means2d + means2d_dummy
    ntx, nty = num_tiles(width, height)
    n_tiles = ntx * nty
    # the tile count whose bits the sort key's tile field takes
    key_tiles = (n_tiles if cfg.fov_extent is None
                 else max(n_tiles, math.prod(num_tiles(*cfg.fov_extent))))

    op_eff = opacities * proj.compensations * proj.valid.to(means.dtype)
    logop = torch.log(torch.clamp(op_eff, min=1e-12))

    radii, valid = proj.radii, proj.valid
    if cfg.tight_radius:
        # pixels beyond r_eff = sigma_max sqrt(2 ln(255 op_eff)) have
        # alpha < 1/255 and are dropped by the compositing gate, so
        # min(3 sigma, r_eff) spans give the same image with fewer entries
        ln_gate = torch.log(255.0 * torch.clamp(op_eff.detach(), min=1e-12))
        sigma_max = radii.float() / 3.0
        r_eff = torch.ceil(sigma_max * torch.sqrt(
            2.0 * torch.clamp(ln_gate, min=0.0)))
        radii = torch.minimum(radii, r_eff.to(torch.int32))
        radii = torch.where(ln_gate > 0.0, radii, torch.zeros_like(radii))
        valid = valid & (radii > 0)

    sp = binning.spans(means2d.detach(), radii, valid, width, height)
    exp = binning.expand_light(sp.counts, cap)
    # a band below the top of a larger image: its sorted entries start at
    # the whole render's entries above it, modulo a chunk, so each tile's
    # compositing chunks, and the early stop at their ends, hold the same
    # entries as in the whole render
    phase = None
    if cfg.row_offset:
        phase = torch.remainder(binning.entries_above(
            means2d.detach(), radii, valid, width, cfg.row_offset // TILE),
            CHUNK)
    dev = means.device
    feat_rows = torch.stack([
        means2d[:, 0], means2d[:, 1],
        proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
        logop,
        colors[:, 0], colors[:, 1], colors[:, 2],
        proj.depths,
    ])
    meta_rows = torch.stack([
        sp.tx0.float(), sp.ty0.float(), sp.span_w.float(),
        exp.offsets[:-1].float(),
        torch.arange(n, dtype=torch.float32, device=dev),
        torch.zeros(n, dtype=torch.float32, device=dev),
    ])
    want_grad = torch.is_grad_enabled() and (
        feat_rows.requires_grad
        or (mean2d_sink is not None and mean2d_sink.requires_grad))
    out, gid_s = _Rasterize.apply(feat_rows, mean2d_sink, phase, meta_rows,
                                  exp.offsets, exp.num_isects, cap, ntx,
                                  n_tiles, key_tiles, width, height,
                                  want_grad)
    rgb, depth_acc, alpha = unpack(out, width, height)
    depth = depth_acc / torch.clamp(alpha, min=1e-10)  # gsplat "ED" depth
    return {
        "rgb": rgb,
        "depth": depth[..., None],
        "alpha": alpha[..., None],
        "info": {
            "means2d": means2d,
            "depths": proj.depths,
            "radii": proj.radii,
            "valid": proj.valid,
            "num_isects": exp.num_isects,
            "overflow": exp.overflow,
            "gauss_ids": gid_s,
        },
    }


def unpack(out, width: int, height: int):
    """(n_tiles, 5, 1024) tiles -> rgb (H, W, 3), depth (H, W), alpha."""
    ntx, nty = num_tiles(width, height)
    x = out.reshape(nty, ntx, 5, TILE, TILE)
    x = x.permute(2, 0, 3, 1, 4).reshape(5, nty * TILE, ntx * TILE)
    x = x[:, :height, :width]
    return x[0:3].permute(1, 2, 0), x[3], x[4]


def absgrad_from_sink(d_sink, gauss_ids, n: int):
    """Per-Gaussian sum of |per-intersection screen gradients| (gsplat's
    `absgrad` statistic, reference base.py:281-286) from the sink's
    gradient and the sorted Gaussian ids (info["gauss_ids"]; entries past
    num_isects carry id n and are dropped)."""
    acc = torch.zeros((n + 1, 2), dtype=d_sink.dtype, device=d_sink.device)
    acc.index_add_(0, torch.clamp(gauss_ids.long(), max=n), d_sink.abs())
    return acc[:n]
