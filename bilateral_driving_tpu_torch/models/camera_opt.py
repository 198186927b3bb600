"""Camera pose refinement, per-image SE(3) deltas: port of
bilateral_driving_tpu/models/camera_opt.py.

Each image has an embedding of 3 translation and 6 rotation (6D) deltas,
zero at init (or drawn with a small std, for the perturbation model). The
identity 6D basis is added before Gram-Schmidt, so a zero embedding gives
exactly the identity, and the delta is right-multiplied onto the
camera-to-world. The trainer applies it to training views only.
"""
from __future__ import annotations

import torch

from ..core import transforms

# the identity rotation's 6D basis, a plain constant: the tensor is made on
# the embeddings' device at each call
IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def init_camera_opt(generator: torch.Generator, num_images: int,
                    std: float = 0.0, device="cuda"):
    if std > 0:
        embeds = std * torch.randn((num_images, 9), generator=generator,
                                   device=generator.device)
    else:
        embeds = torch.zeros((num_images, 9))
    return {"embeds": embeds.to(device)}


def apply_camera_opt(params, camtoworlds: torch.Tensor,
                     img_idx) -> torch.Tensor:
    """camtoworlds (..., 4, 4) @ the delta of image(s) `img_idx`."""
    deltas = params["embeds"][img_idx]
    dx, drot = deltas[..., :3], deltas[..., 3:]
    rot = transforms.rotation_6d_to_matrix(drot + torch.tensor(
        IDENTITY_6D, dtype=deltas.dtype, device=deltas.device))
    return camtoworlds @ transforms.se3_compose(rot, dx)
