"""Error-buffer importance sampling of training images: the port's copy of
bilateral_driving_tpu/data/importance.py, plus `state_dict` and
`load_state_dict` so that a resumed run draws what an uninterrupted one
would.

Counterpart of the reference's `propose_training_image` /
`update_image_error_maps` (project/datasets/base/pixel_source.py:909-983):
with probability `buffer_ratio`, sample the next training image from a
per-image mean-error distribution (optionally up-weighting the first 10% of
frames by `start_enhance_weight`); otherwise sample uniformly. Host-side
numpy — runs in the input pipeline, not on device.
"""
from __future__ import annotations

import numpy as np


class ImageSampler:
    def __init__(self, num_images: int, num_cams: int, buffer_ratio: float = 0.5,
                 start_enhance_weight: float = 1.0, seed: int = 0):
        self.num_images = num_images
        self.num_cams = num_cams
        self.buffer_ratio = buffer_ratio
        self.start_enhance_weight = start_enhance_weight
        self.rng = np.random.RandomState(seed)
        self.error_buffer = np.zeros(num_images, np.float64)
        self.buffered = False

    def update_error(self, image_idx: int, mean_error: float):
        """Trainers feed per-image photometric error whenever they render an
        image (the reference refreshes the whole buffer periodically via a
        full-set render; incremental updates are equivalent and cheaper)."""
        self.error_buffer[image_idx] = mean_error
        self.buffered = True

    def update_all(self, errors: np.ndarray):
        self.error_buffer[:] = errors
        self.buffered = True

    def _weights(self, candidates: np.ndarray) -> np.ndarray:
        w = self.error_buffer[candidates].copy()
        if self.start_enhance_weight > 1.0:
            # ceil: the reference truncates (pixel_source.py:919) but its
            # num_imgs is always divisible by num_cams; ours may not be
            # (synthetic mode), and a short ramp would index out of bounds
            frame_num = -(-self.num_images // self.num_cams)
            n_boost = max(int(frame_num * 0.1), 1)
            ramp = np.concatenate([
                np.linspace(self.start_enhance_weight, 1.0, n_boost),
                np.ones(frame_num - n_boost),
            ])
            per_image = np.repeat(ramp, self.num_cams)[:self.num_images]
            w = w * per_image[candidates]
        s = w.sum()
        if s <= 0:
            return np.full(len(candidates), 1.0 / len(candidates))
        return w / s

    def propose(self, candidates: np.ndarray) -> int:
        candidates = np.asarray(candidates)
        if self.buffered and self.rng.rand() < self.buffer_ratio:
            return int(self.rng.choice(candidates, p=self._weights(candidates)))
        return int(self.rng.choice(candidates))

    def state_dict(self) -> dict:
        return {"rng": self.rng.get_state(),
                "error_buffer": self.error_buffer.copy(),
                "buffered": self.buffered}

    def load_state_dict(self, state: dict):
        self.rng.set_state(state["rng"])
        self.error_buffer[:] = state["error_buffer"]
        self.buffered = bool(state["buffered"])
