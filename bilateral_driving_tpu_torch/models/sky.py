"""EnvLight sky, a learned cube map: port of the EnvLight half of
bilateral_driving_tpu/models/sky.py. The trainer composites
rgb + sky * (1 - opacity); the texture's gradient is splatted by the
cube-map kernel (ops/cubemap.sample_splat), as the JAX trainer's
`envlight_color(..., interpret=...)` does.
"""
from __future__ import annotations

import torch

from ..ops import cubemap

# world -> OpenGL axis permutation applied to view directions
TO_OPENGL = ((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, -1.0, 0.0))


def init_envlight(resolution: int = 1024, device="cuda"):
    return {"base": torch.full((6, resolution, resolution, 3), 0.5,
                               device=device)}


def envlight_color(params, viewdirs: torch.Tensor) -> torch.Tensor:
    """Sky RGB from world view directions (no sigmoid or clamp)."""
    to_gl = torch.tensor(TO_OPENGL, dtype=viewdirs.dtype,
                         device=viewdirs.device)
    return cubemap.sample_splat(params["base"], viewdirs @ to_gl.T)
