"""Metric logging: port of bilateral_driving_tpu/utils/logging.py.

Windowed meters, periodic console lines with an ETA, and a JSONL metrics
file per run (`metrics.json`), as the reference's `MetricLogger` and
`SmoothedValue` (project/utils/logging.py:20-300).
"""
from __future__ import annotations

import collections
import datetime
import json
import logging
import os
import sys
import time
from typing import Dict, Iterable, Optional

logger = logging.getLogger("bilateral_driving_tpu_torch")


def setup_logging(log_dir: Optional[str] = None, level=logging.INFO):
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(log_dir, "log.txt")))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )
    return logger


class SmoothedValue:
    def __init__(self, window: int = 20, fmt: str = "{median:.4f}"):
        self.deque = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        s = sorted(self.deque)
        return s[len(s) // 2] if s else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg)


class MetricLogger:
    def __init__(self, delimiter: str = "  ",
                 output_file: Optional[str] = None):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter
        self.output_file = output_file

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def dump(self, step: int, extra: Optional[Dict] = None):
        """Append one JSONL record (reference dump_in_output_file,
        logging.py:54-65)."""
        if not self.output_file:
            return
        rec = {"step": step,
               **{k: m.median for k, m in self.meters.items()}}
        if extra:
            rec.update(extra)
        with open(self.output_file, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
        """Wrap an iterable, printing smoothed meters + ETA every
        `print_freq` iterations (logging.py:67-143)."""
        items = list(iterable) if not hasattr(iterable, "__len__") else iterable
        total = len(items)
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for i, obj in enumerate(items):
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == total - 1:
                eta = iter_time.avg * (total - i - 1)
                eta_str = str(datetime.timedelta(seconds=int(eta)))
                meters = self.delimiter.join(
                    f"{k}: {v}" for k, v in self.meters.items())
                logger.info(f"{header} [{i}/{total}] eta: {eta_str} "
                            f"{meters} iter_t: {iter_time}")
            end = time.time()
        logger.info(f"{header} done in "
                    f"{datetime.timedelta(seconds=int(time.time() - start))}")
