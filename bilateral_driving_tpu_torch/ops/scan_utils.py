"""Prefix scans that keep int32.

The JAX package's scan_utils reshapes 1-D scans into (rows, 1024) blocks
because XLA on a TPU runs a 1-D scan lane-starved; PyTorch's own scans have
no such layout problem. What stays is the dtype: `torch.cumsum` of int32
returns int64 and `torch.cummax` returns (values, indices), while the binning
integers stay int32 as in the JAX package.
"""
from __future__ import annotations

import torch


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum in x's own dtype."""
    return torch.cumsum(x, 0, dtype=x.dtype)


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix maximum (values only)."""
    return torch.cummax(x, 0).values
