"""Per-intersection expansion: per-Gaussian table -> sort inputs.

Port of bilateral_driving_tpu/ops/expand_pallas.py. `expand_gather` launches
the CUDA kernel `csrc/expand.cu` on CUDA tensors and runs `expand_gather_plain`
(the `expand_gather_xla` formulation) on CPU tensors. Both give the same
bits: keys, gids and features.

Table layout, (16, N) f32, one column per Gaussian:
  0 tx0, 1 ty0, 2 span_w, 3 seg_start, 4 x, 5 y, 6 a, 7 b, 8 c,
  9 logop, 10 r, 11 g, 12 b, 13 depth, 14 orig_id, 15 pad
"""
from __future__ import annotations

import ctypes

import torch

from . import binning, cuda_build

TABLE_ROWS = 16
FEAT0, NFEAT = 4, 10


def expand_gather_plain(table_T, offsets, num_isects, cap: int, ntx: int,
                        n_tiles: int, n_orig: int):
    """Fill + monotone gather + key pack in plain PyTorch."""
    n = offsets.shape[0] - 1
    dev = table_T.device
    g = binning.fill_monotone(torch.arange(n, dtype=torch.int32, device=dev),
                              offsets[:-1], cap)
    m_idx = torch.arange(cap, dtype=torch.int32, device=dev)
    gt = table_T[:, g.long()]                               # (16, cap)
    tile = binning.entry_tiles(
        gt[0].to(torch.int32), gt[1].to(torch.int32),
        torch.clamp(gt[2].to(torch.int32), min=1),
        gt[3].to(torch.int32), m_idx, ntx)
    valid = m_idx < num_isects
    key = binning.pack_keys(tile, gt[13], n_tiles, valid)
    gid = torch.where(valid, gt[14].to(torch.int32),
                      torch.full_like(m_idx, n_orig))
    feats = torch.where(valid[None, :], gt[FEAT0:FEAT0 + NFEAT],
                        torch.zeros((), dtype=gt.dtype, device=dev))
    feats[5] = torch.where(valid, gt[9], torch.full_like(gt[9], -30.0))
    return key, gid, feats


def _launcher():
    fn = cuda_build.load("expand").expand_gather_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, p, p, i, i, i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def expand_gather(table_T, offsets, num_isects, cap: int, ntx: int,
                  n_tiles: int, n_orig: int):
    """(key (cap,) i32, gid (cap,) i32, feats (10, cap) f32) per entry in
    expansion order. table_T: (16, N') f32 with N' >= N; offsets: (N+1,)
    int32 clamped to cap; num_isects: () int32 before truncation."""
    if table_T.device.type == "cpu":
        return expand_gather_plain(table_T, offsets, num_isects, cap, ntx,
                                   n_tiles, n_orig)
    ni = num_isects.reshape(1).to(torch.int32)
    cuda_build.require_cuda(table_T, offsets, ni)
    n = offsets.shape[0] - 1
    if (table_T.dtype != torch.float32 or offsets.dtype != torch.int32
            or table_T.dim() != 2 or table_T.shape[0] != TABLE_ROWS
            or table_T.shape[1] < n or not table_T.is_contiguous()
            or not offsets.is_contiguous()):
        raise ValueError("expand_gather: need a contiguous (16, >=N) f32 "
                         "table and contiguous (N+1,) int32 offsets")
    dev = table_T.device
    key = torch.empty(cap, dtype=torch.int32, device=dev)
    gid = torch.empty(cap, dtype=torch.int32, device=dev)
    feats = torch.empty((NFEAT, cap), dtype=torch.float32, device=dev)
    launch = _launcher()
    cuda_build.check(launch(
        table_T.data_ptr(), n, table_T.shape[1], offsets.data_ptr(),
        ni.data_ptr(), cap, ntx, binning.tile_bits(n_tiles), n_orig,
        key.data_ptr(), gid.data_ptr(), feats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "expand_gather")
    expand_gather.launches += 1
    return key, gid, feats


expand_gather.launches = 0
