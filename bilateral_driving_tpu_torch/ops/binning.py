"""Tile binning: Gaussian -> (tile, depth)-sorted intersection lists.

Port of bilateral_driving_tpu/ops/binning.py. Every integer here must equal
the JAX package's exactly (TILE=32, CHUNK=128), so that intersection lists
and `num_isects` compare entry by entry.
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
    offsets: torch.Tensor     # (N+1,) int32 segment starts, clamped to cap
    num_isects: torch.Tensor  # () int32, before truncation
    overflow: torch.Tensor    # () bool


def expand_light(counts, isect_capacity: int) -> Expansion:
    """Per-Gaussian entry offsets and totals; the expansion kernel recovers
    each entry's Gaussian itself."""
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32,
                                     device=counts.device),
                         scan_utils.cumsum(counts.to(torch.int32))])
    m_total = offsets[-1]
    return Expansion(torch.clamp(offsets, max=isect_capacity), m_total,
                     m_total > isect_capacity)


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
