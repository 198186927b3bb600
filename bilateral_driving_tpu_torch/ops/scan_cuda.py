"""Inclusive prefix scans along rows: port of
bilateral_driving_tpu/ops/scan_pallas.py (`scan_rows`, `scan1d`).

`scan_rows(x, op)` scans each row of an (R, M) float32 or int32 tensor on
its own with op in {"sum", "max", "min"}, in x's dtype. On CUDA tensors it
launches `csrc/scan.cu` (counted in `scan_rows.launches`; `scan1d` is one
row of it), on CPU tensors it runs `scan_rows_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

OPS = ("sum", "max", "min")
DTYPES = {torch.float32: 0, torch.int32: 1}
TILE = 1024        # elements one block scans (csrc/scan.cu kThreads)


def scan_rows_plain(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The same scan by torch's own operators."""
    if op == "sum":
        return torch.cumsum(x, 1, dtype=x.dtype)
    if op == "max":
        return torch.cummax(x, 1).values
    if op == "min":
        return torch.cummin(x, 1).values
    raise ValueError(f"scan op {op!r} not in {OPS}")


def scan_rows(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Inclusive prefix scan of (R, M) along axis 1, each row on its own."""
    if op not in OPS:
        raise ValueError(f"scan op {op!r} not in {OPS}")
    if x.device.type == "cpu":
        return scan_rows_plain(x, op)
    cuda_build.require_cuda(x)
    if x.dim() != 2 or not x.is_contiguous() or x.dtype not in DTYPES:
        raise ValueError("scan_rows: need a contiguous (R, M) float32 or "
                         f"int32 tensor, got {x.dtype} {tuple(x.shape)}")
    rows, m = x.shape
    out = torch.empty_like(x)
    totals = torch.empty((rows, max(-(-m // TILE), 1)), dtype=x.dtype,
                         device=x.device)
    fn = cuda_build.load("scan").scan_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    cuda_build.check(fn(
        x.data_ptr(), out.data_ptr(), totals.data_ptr(), rows, m,
        DTYPES[x.dtype], OPS.index(op),
        torch.cuda.current_stream(x.device).cuda_stream), "scan")
    scan_rows.launches += 1
    return out


scan_rows.launches = 0


def scan1d(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Inclusive scan of a 1-D tensor: one row of scan_rows."""
    return scan_rows(x[None, :], op)[0]
