"""Ragged per-Gaussian segment sums: port of
bilateral_driving_tpu/ops/segsum_pallas.py (`segment_sum`,
`segment_sum_rows`).

The rasterization backward needs, for every Gaussian g, the sum of its
per-intersection gradient columns over the contiguous range
[offsets[g], offsets[g + 1]) of the Gaussian-major (un-sorted) entries. Both
wrappers launch the CUDA kernel `csrc/segsum.cu` on CUDA tensors, each with
its own launch counter, and run `segment_sum_plain` on CPU tensors. The
stacked input reaches the kernel as one base pointer and a row stride, the
split input as an array of row pointers.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

OUT_ROWS = 16      # segment_sum_rows' output rows, the table's row count
MAX_ROWS = 16      # input rows one launch takes
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, ctypes.c_longlong, _P, _I, _I, _I, _P, _I, _P, _P]


def segment_ids(offsets, length: int):
    """(length,) int64 segment of each entry, -1 past offsets[-1]."""
    m = torch.arange(length, device=offsets.device)
    seg = torch.searchsorted(offsets.long(), m, right=True) - 1
    return torch.where(m < offsets[-1].long(), seg, torch.full_like(seg, -1))


def segment_sum_plain(rows, offsets, n_out: int | None = None,
                      row0: int = 0):
    """Sums of each input row (a sequence of (cap,) tensors) over the
    segments, by index_add_ at each entry's segment id. Output row
    row0 + j holds rows[j]'s sums; other rows of the n_out are zero."""
    n = offsets.shape[0] - 1
    n_out = len(rows) if n_out is None else n_out
    dev = offsets.device
    seg = segment_ids(offsets, rows[0].shape[0])
    keep = seg >= 0
    out = torch.zeros((n_out, n), dtype=rows[0].dtype, device=dev)
    data = torch.stack(list(rows))[:, keep]
    out[row0:row0 + len(rows)].index_add_(1, seg[keep], data)
    return out


def _check_offsets(offsets, what: str):
    if (offsets.dtype != torch.int32 or offsets.dim() != 1
            or not offsets.is_contiguous()):
        raise ValueError(f"{what}: need contiguous (N+1,) int32 offsets "
                         "clamped to cap")


def _launch(base, stride: int, ptrs, n_rows: int, offsets, n_out: int,
            row0: int, what: str):
    n = offsets.shape[0] - 1
    dev = offsets.device
    out = torch.empty((n_out, n), dtype=torch.float32, device=dev)
    fn = cuda_build.function("segsum", "segsum_launch", _ARGTYPES)
    cuda_build.check(fn(
        base, stride, ptrs, n_rows, row0, n_out, offsets.data_ptr(), n,
        out.data_ptr(), cuda_build.current_stream(dev)), what)
    return out


def segment_sum(data, offsets):
    """data (R, cap) f32 in Gaussian-major order, offsets (N+1,) int32
    non-decreasing and clamped to cap -> (R, N) per-segment sums."""
    if data.device.type == "cpu":
        return segment_sum_plain(list(data), offsets)
    cuda_build.require_cuda(data, offsets)
    if (data.dim() != 2 or not 1 <= data.shape[0] <= MAX_ROWS
            or data.dtype != torch.float32 or not data.is_contiguous()):
        raise ValueError(f"segment_sum: need contiguous (R <= {MAX_ROWS}, "
                         f"cap) f32 data, got {data.dtype} "
                         f"{tuple(data.shape)}")
    _check_offsets(offsets, "segment_sum")
    rows = data.shape[0]
    out = _launch(data.data_ptr(), data.shape[1], None, rows, offsets, rows,
                  0, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def segment_sum_rows(rows, offsets, row0: int = 0):
    """Split input: `rows` is a sequence of R (cap,) f32 tensors. Returns
    (16, N) where row row0 + j sums rows[j] and the other rows are zero."""
    rows = list(rows)
    if row0 < 0 or row0 + len(rows) > OUT_ROWS:
        raise ValueError(f"segment_sum_rows: rows {row0}..{row0 + len(rows)} "
                         f"outside the {OUT_ROWS} output rows")
    if rows[0].device.type == "cpu":
        return segment_sum_plain(rows, offsets, OUT_ROWS, row0)
    cuda_build.require_cuda(offsets, *rows)
    cap = rows[0].shape[0]
    if any(r.dtype != torch.float32 or r.shape != (cap,)
           or not r.is_contiguous() for r in rows):
        raise ValueError("segment_sum_rows: need contiguous (cap,) f32 rows")
    _check_offsets(offsets, "segment_sum_rows")
    ptrs = (ctypes.c_void_p * len(rows))(*[r.data_ptr() for r in rows])
    out = _launch(None, 0, ptrs, len(rows), offsets, OUT_ROWS, row0,
                  "segment_sum_rows")
    segment_sum_rows.launches += 1
    return out


segment_sum_rows.launches = 0
