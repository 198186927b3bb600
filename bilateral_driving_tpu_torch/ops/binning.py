"""Tile binning: Gaussian -> (tile, depth)-sorted intersection lists.

Port of bilateral_driving_tpu/ops/binning.py. Every integer here must equal
the JAX package's exactly (TILE=32, CHUNK=128), so that intersection lists
and `num_isects` compare entry by entry. The render pipeline (ops/pipeline)
runs these stages with the feature rows riding its sort; `bin_gaussians`
is the same binning on its own, with `expand`'s capacity-sized fill of
each entry's Gaussian, for inspection and tests.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import scan_utils

TILE = 32          # pixel tile edge
CHUNK = 128        # intersections per compositing chunk
INT_MAX = 2 ** 31 - 1


def num_tiles(width: int, height: int) -> tuple[int, int]:
    return (-(-width // TILE), -(-height // TILE))


def tile_bits(n_tiles: int) -> int:
    bits = 1
    while (1 << bits) <= n_tiles:
        bits += 1
    return bits


def quantize_depth_like_sort(depths, n_tiles: int):
    """Depths as the packed sort key sees them: float32, clamped at 0, the
    low tile_bits(n_tiles) bits of the float's pattern cleared."""
    shift = tile_bits(n_tiles)
    # + 0.0 turns the clamp's -0.0 into the +0.0 that jnp.maximum gives
    bits = (torch.clamp(depths.to(torch.float32), min=0.0) + 0.0).view(
        torch.int32)
    return ((bits >> shift) << shift).view(torch.float32)


def fill_monotone(values_at, positions, size: int):
    """out[m] = values_at[i] for the largest positions[i] <= m (values
    non-decreasing in scatter order): scatter-max then prefix max."""
    keep = positions < size
    base = torch.zeros(size, dtype=torch.int32, device=positions.device)
    base.scatter_reduce_(0, positions[keep].long(), values_at[keep],
                         reduce="amax")
    return scan_utils.cummax(base)


class Spans(NamedTuple):
    tx0: torch.Tensor      # (N,) int32
    ty0: torch.Tensor      # (N,) int32
    span_w: torch.Tensor   # (N,) int32 (>= 1)
    counts: torch.Tensor   # (N,) int32 tiles overlapped (0 for culled)


def spans(means2d, radii, valid, width: int, height: int) -> Spans:
    """Per-Gaussian tile spans (inclusive-exclusive, clamped)."""
    ntx, nty = num_tiles(width, height)
    r = radii.float()
    x, y = means2d[..., 0], means2d[..., 1]
    tx0 = torch.clamp(torch.floor((x - r) / TILE), 0, ntx).to(torch.int32)
    tx1 = torch.clamp(torch.ceil((x + r) / TILE), 0, ntx).to(torch.int32)
    ty0 = torch.clamp(torch.floor((y - r) / TILE), 0, nty).to(torch.int32)
    ty1 = torch.clamp(torch.ceil((y + r) / TILE), 0, nty).to(torch.int32)
    counts = torch.where(valid & (radii > 0), (tx1 - tx0) * (ty1 - ty0),
                         torch.zeros_like(tx0))
    return Spans(tx0, ty0, torch.clamp(tx1 - tx0, min=1), counts)


def entries_above(means2d, radii, valid, width: int, tile_rows: int):
    """() int64: the entries `spans` would give the `tile_rows` tile rows
    just above the render (the rows of a larger image above a band whose
    means2d are the band's)."""
    ntx, _ = num_tiles(width, TILE)
    r = radii.float()
    x, y = means2d[..., 0], means2d[..., 1]
    tx0 = torch.clamp(torch.floor((x - r) / TILE), 0, ntx)
    tx1 = torch.clamp(torch.ceil((x + r) / TILE), 0, ntx)
    ty0 = torch.clamp(torch.floor((y - r) / TILE), -tile_rows, 0)
    ty1 = torch.clamp(torch.ceil((y + r) / TILE), -tile_rows, 0)
    n = torch.where(valid & (radii > 0), (tx1 - tx0) * (ty1 - ty0),
                    torch.zeros_like(tx0))
    return torch.sum(n.to(torch.int64))


class Expansion(NamedTuple):
    g: torch.Tensor            # (cap,) int32 each entry's Gaussian
    m_idx: torch.Tensor        # (cap,) int32 arange
    offsets: torch.Tensor      # (N+1,) int32 segment starts, clamped to cap
    entry_valid: torch.Tensor  # (cap,) bool, m_idx < num_isects
    num_isects: torch.Tensor   # () int32, before truncation
    overflow: torch.Tensor     # () bool


def expand(counts, isect_capacity: int) -> Expansion:
    """Per-Gaussian counts -> entries 0..cap-1, each with its Gaussian: the
    offsets' prefix sum, then fill_monotone of the Gaussian ids at their
    segment starts."""
    ex = expand_light(counts, isect_capacity)
    m_idx = torch.arange(isect_capacity, dtype=torch.int32,
                         device=counts.device)
    g = fill_monotone(torch.arange(counts.shape[0], dtype=torch.int32,
                                   device=counts.device),
                      ex.offsets[:-1], isect_capacity)
    return ex._replace(g=g, m_idx=m_idx, entry_valid=m_idx < ex.num_isects)


def expand_light(counts, isect_capacity: int) -> Expansion:
    """`expand` without the capacity-sized fill (`g`, `m_idx` and
    `entry_valid` empty): the expansion kernel recovers each entry's
    Gaussian itself."""
    dev = counts.device
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         scan_utils.cumsum(counts.to(torch.int32))])
    m_total = offsets[-1]
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    return Expansion(empty, empty, torch.clamp(offsets, max=isect_capacity),
                     empty.bool(), m_total, m_total > isect_capacity)


def entry_tiles(g_tx0, g_ty0, g_sw, g_seg_start, m_idx, ntx: int):
    """Per-entry tile id from the gathered span columns (expansion order)."""
    k = m_idx - g_seg_start
    ty = g_ty0 + torch.div(k, g_sw, rounding_mode="floor")
    tx = g_tx0 + torch.remainder(k, g_sw)
    return ty * ntx + tx


def pack_keys(tile, depths_exp, n_tiles: int, entry_valid):
    """One packed 31-bit sort key: tile | truncated positive-float depth
    bits (positive float bit patterns order like the floats)."""
    tb = tile_bits(n_tiles)
    # the bits of the float32 depth, whatever the features' dtype
    depth_bits = torch.clamp(depths_exp.to(torch.float32),
                             min=0.0).view(torch.int32)
    key = (tile << (31 - tb)) | (depth_bits >> tb)
    return torch.where(entry_valid, key, torch.full_like(key, INT_MAX))


def tiles_of_keys(key_s, n_tiles: int):
    tb = tile_bits(n_tiles)
    return torch.where(key_s == INT_MAX, torch.full_like(key_s, n_tiles),
                       key_s >> (31 - tb))


def tile_ranges(tile_s, m_total, n_tiles: int, isect_capacity: int):
    """Per-tile (start, count) in the sorted buffer: `tile_s` is
    non-decreasing, so the edges are a searchsorted."""
    m_total_c = torch.clamp(m_total, max=isect_capacity)
    edges = torch.searchsorted(
        tile_s, torch.arange(n_tiles + 1, dtype=tile_s.dtype,
                             device=tile_s.device), right=False)
    edges = torch.minimum(edges.to(torch.int32), m_total_c)
    return edges[:-1].contiguous(), (edges[1:] - edges[:-1]).contiguous()


class Intersections(NamedTuple):
    """Sorted intersection lists of `bin_gaussians`."""
    gauss_ids: torch.Tensor    # (cap,) int32 in [0, N); junk past num_isects
    isect_tile: torch.Tensor   # (cap,) int32 owning tile (n_tiles: none)
    tile_counts: torch.Tensor  # (n_tiles,) int32
    tile_starts: torch.Tensor  # (n_tiles,) int32 starts in the sorted lists
    eidx: torch.Tensor         # (cap,) int32 expansion index at each place
    num_isects: torch.Tensor   # () int32 entries before truncation
    overflow: torch.Tensor     # () bool: isect_capacity exceeded
    offsets: torch.Tensor      # (N+1,) per-Gaussian expansion boundaries


def bin_gaussians(means2d, radii, depths, valid, width: int, height: int,
                  isect_capacity: int) -> Intersections:
    """Standalone binning without feature rows: spans, expand, each
    entry's tile, the packed tile|depth key and a sort of the keys. The
    sort is stable, so entries of equal keys keep expansion order, which
    is Gaussian order (the JAX package's sort is not stable: its order of
    equal keys is unspecified)."""
    ntx, nty = num_tiles(width, height)
    n_tiles = ntx * nty
    sp = spans(means2d, radii, valid, width, height)
    ex = expand(sp.counts, isect_capacity)
    g = ex.g.long()
    tile = entry_tiles(sp.tx0[g], sp.ty0[g], sp.span_w[g], ex.offsets[g],
                       ex.m_idx, ntx)
    key = pack_keys(tile, depths[g], n_tiles, ex.entry_valid)
    key_s, order = torch.sort(key, stable=True)
    tile_s = tiles_of_keys(key_s, n_tiles)
    starts, cnt = tile_ranges(tile_s, ex.num_isects, n_tiles, isect_capacity)
    return Intersections(
        gauss_ids=ex.g[order], isect_tile=tile_s, tile_counts=cnt,
        tile_starts=starts, eidx=order.to(torch.int32),
        num_isects=ex.num_isects, overflow=ex.overflow, offsets=ex.offsets)
