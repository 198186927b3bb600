"""Sky models: port of bilateral_driving_tpu/models/sky.py, the MLP sky
and the EnvLight learned cube map. The trainer composites
rgb + sky * (1 - opacity) (trainer.forward); `sky_model="none"` composites
a zero sky and has no parameters. EnvLight's texture gradient is splatted
by the cube-map kernel (ops/cubemap.sample_splat), as the JAX trainer's
`envlight_color(..., interpret=...)` does; the MLP sky is plain PyTorch
(its JAX counterpart reaches no Pallas kernel).
"""
from __future__ import annotations

import torch

from ..ops import cubemap
from . import encoders

SKY_MODELS = ("envlight", "mlp", "none")    # TrainerConfig.sky_model
# world -> OpenGL axis permutation applied to view directions
TO_OPENGL = ((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, -1.0, 0.0))
SKY_SKIPS = (1,)          # the MLP head's second layer takes the input too
SKY_MAX_DEG = 6           # sinusoidal encoding of the view direction, 0..6


def init_sky_mlp(num_images: int, generator: torch.Generator,
                 head_width: int = 64, appearance_dim: int = 16,
                 device="cuda"):
    """Per-image appearance codes (standard normal) and a 3-layer head
    (skip at layer 1) from the encoded view direction and the code to
    RGB."""
    in_dim = encoders.sinusoidal_dim(3, 0, SKY_MAX_DEG) + appearance_dim
    return {
        "embedding": encoders.embedding_init(num_images, appearance_dim,
                                             generator, device),
        "head": encoders.mlp_init(generator, in_dim, 3, 3, head_width,
                                  skips=SKY_SKIPS, device=device),
    }


def sky_mlp_color(params, viewdirs: torch.Tensor, img_idx,
                  use_mean_embedding: bool = False) -> torch.Tensor:
    """(..., 3) sky RGB in (0, 1): the image's code, or on test views the
    mean code, with the sinusoidal encoding of each view direction
    through the head and a sigmoid."""
    enc = encoders.sinusoidal_encode(viewdirs, 0, SKY_MAX_DEG)
    table = params["embedding"]
    emb = table.mean(dim=0) if use_mean_embedding else table[int(img_idx)]
    emb = emb.expand(*enc.shape[:-1], emb.shape[-1])
    out = encoders.mlp_apply(params["head"], torch.cat([enc, emb], dim=-1),
                             SKY_SKIPS)
    return torch.sigmoid(out)


def init_envlight(resolution: int = 1024, device="cuda"):
    return {"base": torch.full((6, resolution, resolution, 3), 0.5,
                               device=device)}


def envlight_color(params, viewdirs: torch.Tensor) -> torch.Tensor:
    """Sky RGB from world view directions (no sigmoid or clamp)."""
    to_gl = torch.tensor(TO_OPENGL, dtype=viewdirs.dtype,
                         device=viewdirs.device)
    return cubemap.sample_splat(params["base"], viewdirs @ to_gl.T)
