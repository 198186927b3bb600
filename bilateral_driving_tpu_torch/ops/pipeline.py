"""Tiled rasterization pipeline, forward only: port of
bilateral_driving_tpu/ops/pipeline.py.

projection -> opacity-aware tile spans -> entry offsets -> expansion kernel
(per-entry sort key, Gaussian id and features) -> stable sort by key ->
per-tile ranges -> compositing kernel. The JAX package sorts with
`lax.sort(num_keys=2)` on (key, gid); entries are produced in Gaussian-id
order, so a stable sort on the key alone gives the same order.

Gradients are a later slice: this module renders (no autograd Function).
"""
from __future__ import annotations

import dataclasses

import torch

from . import binning, expand_cuda, projection, rasterize_cuda
from .binning import TILE, num_tiles

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


def probe_num_isects(means, quats, scales, viewmat, K, width: int,
                     height: int, cfg: RasterizeConfig | None = None) -> int:
    """Projection + tile spans only, counting the scene's tile
    intersections for `autotune_capacity`."""
    cfg = cfg or RasterizeConfig()
    proj = projection.project(
        means, quats, scales, viewmat, K, width, height,
        near_plane=cfg.near_plane, far_plane=cfg.far_plane,
        radius_clip=cfg.radius_clip, antialiased=cfg.antialiased)
    sp = binning.spans(proj.means2d, proj.radii, proj.valid, width, height)
    return int(torch.sum(sp.counts.long()))


def autotune_capacity(num_isects: int, margin: float = 1.35,
                      floor: int = CAP_BUCKET) -> int:
    """Intersection capacity from measured occupancy, in multiples of
    CAP_BUCKET so a changing scene rarely changes it."""
    want = max(int(num_isects * margin), floor)
    return -(-want // CAP_BUCKET) * CAP_BUCKET


@torch.no_grad()
def rasterize(means, quats, scales, opacities, colors, viewmat, K,
              width: int, height: int,
              cfg: RasterizeConfig = RasterizeConfig()):
    """Tiled rasterization of N Gaussians into one camera.

    Args:
      means/quats/scales: (N,3), (N,4), (N,3) world-space geometry.
      opacities: (N,) in [0, 1]; colors: (N, 3) RGB after SH.
      viewmat: (4, 4) world -> camera; K: (3, 3).
    Returns:
      dict with rgb (H, W, 3), depth (H, W, 1) expected depth, alpha
      (H, W, 1), and info {means2d, depths, radii, valid, num_isects,
      overflow, gauss_ids}. Past `isect_capacity` the entries are
      truncated and info["overflow"] is True.
    """
    n = means.shape[0]
    cap = cfg.isect_capacity
    proj = projection.project(
        means, quats, scales, viewmat, K, width, height,
        near_plane=cfg.near_plane, far_plane=cfg.far_plane,
        radius_clip=cfg.radius_clip, antialiased=cfg.antialiased)
    ntx, nty = num_tiles(width, height)
    n_tiles = ntx * nty

    op_eff = opacities * proj.compensations * proj.valid.to(means.dtype)
    logop = torch.log(torch.clamp(op_eff, min=1e-12))

    radii, valid = proj.radii, proj.valid
    if cfg.tight_radius:
        # pixels beyond r_eff = sigma_max sqrt(2 ln(255 op_eff)) have
        # alpha < 1/255 and are dropped by the compositing gate, so
        # min(3 sigma, r_eff) spans give the same image with fewer entries
        ln_gate = torch.log(255.0 * torch.clamp(op_eff, min=1e-12))
        sigma_max = radii.float() / 3.0
        r_eff = torch.ceil(sigma_max * torch.sqrt(
            2.0 * torch.clamp(ln_gate, min=0.0)))
        radii = torch.minimum(radii, r_eff.to(torch.int32))
        radii = torch.where(ln_gate > 0.0, radii, torch.zeros_like(radii))
        valid = valid & (radii > 0)

    sp = binning.spans(proj.means2d, radii, valid, width, height)
    exp = binning.expand_light(sp.counts, cap)
    table_T = torch.stack([
        sp.tx0.float(), sp.ty0.float(), sp.span_w.float(),
        exp.offsets[:-1].float(),
        proj.means2d[:, 0], proj.means2d[:, 1],
        proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
        logop,
        colors[:, 0], colors[:, 1], colors[:, 2],
        proj.depths,
        torch.arange(n, dtype=torch.float32, device=means.device),
        torch.zeros(n, dtype=torch.float32, device=means.device),
    ])
    key, gid, feats = expand_cuda.expand_gather(
        table_T, exp.offsets, exp.num_isects, cap, ntx, n_tiles, n)
    key_s, perm = torch.sort(key, stable=True)
    gid_s = gid[perm]
    feats_s = feats[:, perm]
    starts, counts = binning.tile_ranges(
        binning.tiles_of_keys(key_s, n_tiles), exp.num_isects, n_tiles, cap)

    out = rasterize_cuda.rasterize_fwd(feats_s, starts, counts, width, height)
    rgb, depth_acc, alpha = unpack(out, width, height)
    depth = depth_acc / torch.clamp(alpha, min=1e-10)  # gsplat "ED" depth
    return {
        "rgb": rgb,
        "depth": depth[..., None],
        "alpha": alpha[..., None],
        "info": {
            "means2d": proj.means2d,
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
