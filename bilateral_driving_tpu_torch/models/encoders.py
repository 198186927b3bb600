"""Embedding tables: the part of bilateral_driving_tpu/models/encoders.py
the flagship render path uses (per-instance codes of DeformableNodes)."""
from __future__ import annotations

import torch


def embedding_init(num: int, dim: int, generator: torch.Generator,
                   device="cuda") -> torch.Tensor:
    """(num, dim) standard-normal codes."""
    return torch.randn((num, dim), generator=generator,
                       device=generator.device).to(device)
