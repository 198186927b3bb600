"""Intra-image tile parallelism: port of
bilateral_driving_tpu/parallel/tile_parallel.py.

One image's rasterization is cut into horizontal bands of whole 32-pixel
tile rows, one band per rank of a `tile` group. A band is the same camera
with its projected means moved up by the band's first row y0 and the
Jacobian's frustum clamped with the full image's field of view, so each
rank runs the whole pipeline and every kernel on its band without
communication; the bands are then gathered and cropped.

Five choices make a band composite the whole render's entries of its
rows in the whole render's order and chunks (RasterizeConfig.fov_extent
and row_offset), where the JAX package's bands differ from its full
render where Gaussians crowd:
  * the means are the full image's less y0, subtracted after the
    principal point is added (the JAX package moves K[1, 2] by -y0, which
    rounds the means otherwise);
  * the sort key splits its bits between tile and depth as the full
    image's does, so near-equal depths composite in the same order (a
    band's fewer tiles give depth more bits in the JAX package);
  * the last band is rendered at the rows the image has left, so the cull
    stops at the image's last row as the full render's does (the JAX
    package renders the whole band, where Gaussians below the image add
    entries and light to the image's last rows);
  * the projection culls against the full image's rows, so a band's radii
    and valid flags are the whole render's (its spans clip them to the
    band) and it can count the whole render's entries above it;
  * the band's sorted entries start where the whole render's rows of the
    band start modulo a 128-entry compositing chunk, so every tile's
    chunks hold the same entries and the per-tile early stop (after a
    chunk in which no pixel keeps a transmittance above 1e-4) falls after
    the same entry; misplaced, a band composites more or fewer entries
    than the whole render, up to 1e-4 of alpha and of the largest colour.
What is left is rounding: a Gaussian whose mean lies above y0 can round
when moved by -y0.
The gathered band keeps the band height, zero past the image; a band
wholly past the image renders nothing.

Training (tile_train_step): every rank of a tile group computes the whole
step on the gathered image, so the loss and everything after the gather
are the same on each. The gather's backward hands each rank n_band times
its own band's cotangent (what the JAX package's all_gather transpose,
a psum_scatter of equal cotangents, gives), so each band path's gradient
is n_band times its share; the replicated path (sky, appearance) gives
the full gradient on every rank. The mean over the tile group is then
exactly the full gradient, and the screen-gradient dummy too. On a
(data x tile) grid every gradient is also averaged over the data group
(the batch mean), the dummy summed over it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch
import torch.distributed as dist

from ..ops import binning, pipeline
from ..train import trainer as trainer_mod
from . import data_parallel


def band_height(height: int, n_devices: int) -> int:
    """Whole-tile-row band height covering the image across n devices."""
    nty = -(-height // binning.TILE)
    rows_per = -(-nty // n_devices)
    return rows_per * binning.TILE


def band_rows(height: int, band: int, n_band: int):
    """(first row, band height, rows of the image in the band) of a band."""
    bh = band_height(height, n_band)
    y0 = band * bh
    return y0, bh, max(min(bh, height - y0), 0)


@dataclasses.dataclass(frozen=True)
class HybridMesh:
    """This rank's place in an (n_data x n_tile) grid of ranks, rank r at
    data row r // n_tile and tile column r % n_tile: `data` is the group of
    its tile column (one rank per data row), `tile` the group of its data
    row (the bands of one image). `group` None is the whole process group.
    """
    data: data_parallel.Mesh
    tile: data_parallel.Mesh
    group: object = None

    @property
    def size(self) -> int:
        return self.data.size * self.tile.size

    @property
    def device(self) -> torch.device:
        return self.tile.device


def make_hybrid_mesh(n_data: int, n_tile: int, device) -> HybridMesh:
    """(data x tile) mesh over the process group: each data row trains one
    image whose rasterization is band-split over its tile row. Every rank
    creates every subgroup, in the same order."""
    flat = data_parallel.make_mesh(device=device)
    need = n_data * n_tile
    if need != flat.size:
        raise ValueError(f"hybrid mesh {n_data}x{n_tile} needs {need} "
                         f"devices, have {flat.size}")
    d, t = divmod(flat.rank, n_tile)
    rows = [dist.new_group([i * n_tile + j for j in range(n_tile)])
            for i in range(n_data)]
    cols = [dist.new_group([i * n_tile + j for i in range(n_data)])
            for j in range(n_tile)]
    return HybridMesh(
        data=data_parallel.Mesh(cols[t], n_data, d, flat.device, "data"),
        tile=data_parallel.Mesh(rows[d], n_tile, t, flat.device, "tile"))


def shard_data_batch(stacked, mesh: HybridMesh) -> Dict:
    """This rank's data row of a stacked batch, on its device (every rank
    of a tile row takes the same image)."""
    return data_parallel.shard_batch(stacked, mesh.data)


def render_band(means, quats, scales, opacities, colors, viewmat, K,
                width: int, height: int, cfg: pipeline.RasterizeConfig,
                band: int, n_band: int, mean2d_sink=None,
                means2d_dummy=None) -> Dict:
    """Band `band` of `n_band` of the (width, height) image, with no
    collective: pipeline.rasterize's dict, its images (band height, W, C)
    with zeros past the image. A band wholly past the image has no
    entries, zero images and zero radii."""
    y0, bh, rows = band_rows(height, band, n_band)
    if rows == 0:
        n = means.shape[0]
        zeros = means.new_zeros((bh, width, 1))
        return {"rgb": zeros.expand(bh, width, 3), "depth": zeros,
                "alpha": zeros,
                "info": {"radii": torch.zeros(n, dtype=torch.int32,
                                              device=means.device),
                         "valid": torch.zeros(n, dtype=torch.bool,
                                              device=means.device),
                         "num_isects": torch.zeros((), dtype=torch.int32,
                                                   device=means.device),
                         "overflow": torch.zeros((), dtype=torch.bool,
                                                 device=means.device)}}
    out = pipeline.rasterize(
        means, quats, scales, opacities, colors, viewmat, K, width, rows,
        dataclasses.replace(cfg, fov_extent=(width, height), row_offset=y0),
        means2d_dummy=means2d_dummy, mean2d_sink=mean2d_sink)
    if rows < bh:
        for k in ("rgb", "depth", "alpha"):
            out[k] = torch.nn.functional.pad(out[k], (0, 0, 0, 0, 0,
                                                      bh - rows))
    return out


class _GatherBands(torch.autograd.Function):
    """(bh, W, C) band of every rank of a tile group -> the (n_band bh,
    W, C) stack; backward: n_band times this rank's rows of the cotangent
    (every rank computes the same loss on the stack)."""

    @staticmethod
    def forward(ctx, band, mesh: data_parallel.Mesh):
        band = band.contiguous()
        parts = [torch.empty_like(band) for _ in range(mesh.size)]
        dist.all_gather(parts, band, group=mesh.group)
        ctx.rows = (mesh.rank * band.shape[0], band.shape[0], mesh.size)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r0, bh, n_band = ctx.rows
        return g[r0:r0 + bh] * n_band, None


def gather_bands(band: torch.Tensor, mesh: data_parallel.Mesh,
                 height: int) -> torch.Tensor:
    """The tile group's bands stitched into the (height, W, C) image."""
    return _GatherBands.apply(band, mesh)[:height]


def reduce_band_info(info: Dict, mesh: data_parallel.Mesh) -> Dict:
    """Radii, valid and overflow maxed and num_isects summed over the
    bands; the per-entry fields stay band-local."""
    info = dict(info)
    radii, valid, overflow = data_parallel.all_reduce_in_order(
        [info["radii"], info["valid"], info["overflow"]], dist.ReduceOp.MAX,
        mesh.group)
    (num_isects,) = data_parallel.all_reduce_in_order(
        [info["num_isects"]], dist.ReduceOp.SUM, mesh.group)
    info.update(radii=radii, valid=valid.bool(), overflow=overflow.bool(),
                num_isects=num_isects)
    return info


def banded_rasterize_fn(mesh: data_parallel.Mesh):
    """A pipeline.rasterize-compatible function that renders this rank's
    band of the tile group `mesh` and returns the gathered image."""

    def rfn(means, quats, scales, opacities, colors, viewmat, K, width,
            height, cfg, mean2d_sink=None, means2d_dummy=None):
        out = render_band(means, quats, scales, opacities, colors, viewmat,
                          K, width, height, cfg, mesh.rank, mesh.size,
                          mean2d_sink=mean2d_sink,
                          means2d_dummy=means2d_dummy)
        return {"rgb": gather_bands(out["rgb"], mesh, height),
                "depth": gather_bands(out["depth"], mesh, height),
                "alpha": gather_bands(out["alpha"], mesh, height),
                "info": reduce_band_info(out["info"], mesh)}

    return rfn


def tile_sharded_rasterize(mesh: data_parallel.Mesh, means, quats, scales,
                           opacities, colors, viewmat, K, width: int,
                           height: int,
                           cfg: pipeline.RasterizeConfig =
                           pipeline.RasterizeConfig()) -> Dict:
    """Differentiable full-image rasterization split into bands over the
    tile group `mesh`; cfg.isect_capacity is per band. The images are the
    whole image's; radii and valid are maxed, num_isects summed and
    overflow maxed over the bands."""
    out = banded_rasterize_fn(mesh)(means, quats, scales, opacities, colors,
                                    viewmat, K, width, height, cfg)
    info = out["info"]
    out["info"] = {k: info[k] for k in ("radii", "valid", "num_isects",
                                        "overflow")}
    return out


def make_render_fn(mesh: data_parallel.Mesh, width: int, height: int,
                   cfg: pipeline.RasterizeConfig):
    """Single-image band-split renderer of the tile group `mesh`."""
    return functools.partial(tile_sharded_rasterize, mesh, width=width,
                             height=height, cfg=cfg)


def tile_train_step(cfg, statics, mesh: HybridMesh):
    """A train step over a (data x tile) mesh (n_data 1: tile only): each
    data row's image band-split over its tile row, gradients averaged over
    both groups, the dummy averaged over the tile and summed over the data
    group, PSNR averaged, radii and overflow maxed, num_isects (the tile
    row's sum) summed over the data group; then the same update and
    refinement on every rank. cfg.isect_capacity is per band.

    Returns step(state, batch) -> (state, metrics), `batch` being this
    rank's data row (shard_data_batch)."""
    rfn = banded_rasterize_fn(mesh.tile)

    def step(state, batch):
        total, loss_dict, outputs, g_params, g_dummy = \
            trainer_mod.compute_grads(cfg, statics, state, batch,
                                      rasterize_fn=rfn)
        info = outputs["info"]
        total, loss_dict, g_params, psnr, (g_dummy,), (radii, overflow) = \
            data_parallel.reduce_grads(
                total, loss_dict, g_params,
                trainer_mod.image_psnr(outputs, batch), mesh.group,
                mesh.size, sums=(g_dummy,),
                maxes=(info["radii"], info["overflow"]))
        g_dummy = g_dummy / mesh.tile.size
        (num_isects,) = data_parallel.all_reduce_in_order(
            [info["num_isects"]], dist.ReduceOp.SUM, mesh.data.group)
        return trainer_mod.update_and_refine(
            cfg, statics, state, batch["pixels"].shape[:2], total, loss_dict,
            g_params, g_dummy, radii, overflow.bool(), num_isects, psnr)

    return step
