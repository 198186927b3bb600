"""Row gathers whose CPU gradient does not depend on torch's thread count.

The backward of `table[idx]` on the CPU accumulates the rows of the
cotangent in the order its threads finish, so a run's bits change with
`torch.set_num_threads`. `index_select`'s backward is an `index_add_`,
which on the CPU adds in index order at any thread count. On CUDA the
plain gather stays: its backward sorts the indices and sums in a fixed
order, where `index_add_` would add with atomics.
"""
from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for an int64 index tensor of any shape: rows of `table`
    along its first dimension, (*idx.shape, *table.shape[1:])."""
    if table.is_cuda:
        return table[idx]
    rows = table.index_select(0, idx.reshape(-1))
    return rows.reshape(*idx.shape, *table.shape[1:])
