"""Per-group learning-rate schedules: port of
bilateral_driving_tpu/train/schedules.py as the trainer uses it (no delay,
linear warmup). Linear warmup from `lr_pre_warmup`, then log-linear decay
from lr_init to lr_final over max_steps. A schedule maps a step count to
the absolute learning rate, evaluated in float32 as the JAX package does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LRConfig(NamedTuple):
    lr_init: float
    lr_final: float | None = None
    warmup_steps: int = 0
    lr_pre_warmup: float = 1e-8
    max_steps: int = 30000


def make_schedule(cfg: LRConfig):
    lr_final = cfg.lr_final if cfg.lr_final is not None else cfg.lr_init
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        warm = f32(cfg.lr_pre_warmup) + f32(
            cfg.lr_init - cfg.lr_pre_warmup) * step / f32(
                max(cfg.warmup_steps, 1))
        t = np.clip((step - f32(cfg.warmup_steps))
                    / f32(max(cfg.max_steps - cfg.warmup_steps, 1)),
                    f32(0), f32(1))
        decay = np.exp(np.log(f32(cfg.lr_init)) * (f32(1) - t)
                       + np.log(f32(lr_final)) * t)
        return float(warm if step < cfg.warmup_steps else decay)

    return schedule
