"""1-D prefix scans in the input's own dtype: port of
bilateral_driving_tpu/ops/scan_utils.py.

The JAX package reshapes 1-D scans into (rows, 1024) blocks because XLA on
a TPU runs a 1-D scan lane-starved, and kept its Pallas scan kernel
(scan_pallas.py) beside them. Here every scan is one row of the port of
that kernel, `scan_cuda.scan1d`: the CUDA kernel on the card, torch's
cumsum/cummax/cummin on the CPU. The binning integers stay int32 as in the
JAX package (`torch.cumsum` of int32 alone would return int64).
"""
from __future__ import annotations

import torch

from . import scan_cuda


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum in x's own dtype."""
    return scan_cuda.scan1d(x, "sum")


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix maximum (values only)."""
    return scan_cuda.scan1d(x, "max")


def cummin(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix minimum (values only)."""
    return scan_cuda.scan1d(x, "min")
