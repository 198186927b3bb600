"""Per-image affine colour transform, the OmniRe appearance-code baseline:
port of bilateral_driving_tpu/models/affine.py.

A per-image embedding goes through a small MLP to one 3 x 4 affine. The
embedding and the whole decoder start at zero, so every image starts at
the identity; test views use the mean embedding. An optional per-pixel
variant concatenates pixel coordinates to the embedding. The affine is
regularised toward the identity.
"""
from __future__ import annotations

import torch

from . import encoders


def init_affine(generator: torch.Generator, num_images: int,
                embedding_dim: int = 4, pixel_affine: bool = False,
                hidden: int = 64, device="cuda"):
    in_dim = embedding_dim + (2 if pixel_affine else 0)
    return {
        "embedding": torch.zeros((num_images, embedding_dim), device=device),
        "decoder": encoders.mlp_init(generator, in_dim, 12, 2, hidden,
                                     zero_init_all=True, device=device),
    }


def affine_mats(params, img_idx, pixel_coords: torch.Tensor | None = None,
                use_mean_embedding: bool = False) -> torch.Tensor:
    """(..., 3, 4) affine, the identity added to its linear part; with
    `pixel_coords` (..., 2) one per pixel."""
    table = params["embedding"]
    emb = table.mean(dim=0) if use_mean_embedding else table[img_idx]
    if pixel_coords is not None:
        emb = emb.expand(*pixel_coords.shape[:-1], emb.shape[-1])
        emb = torch.cat([emb, pixel_coords], dim=-1)
    out = encoders.mlp_apply(params["decoder"], emb)
    mats = out.reshape(*out.shape[:-1], 3, 4)
    return mats + torch.eye(3, 4, dtype=mats.dtype, device=mats.device)


def identity_reg_loss(mats: torch.Tensor) -> torch.Tensor:
    """mean |A - I| + mean |t|."""
    eye = torch.eye(3, dtype=mats.dtype, device=mats.device)
    return (torch.mean(torch.abs(mats[..., :3, :3] - eye))
            + torch.mean(torch.abs(mats[..., :3, 3])))
