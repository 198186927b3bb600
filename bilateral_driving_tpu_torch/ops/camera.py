"""World -> camera transform for the render path: the `viewmat` of
bilateral_driving_tpu/ops/camera.py's Camera, without flax."""
from __future__ import annotations

import torch


def viewmat_from_c2w(c2w: torch.Tensor) -> torch.Tensor:
    """world -> camera, the closed-form SE(3) inverse of camtoworld."""
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    view = torch.eye(4, dtype=c2w.dtype, device=c2w.device)
    view[:3, :3] = R.T
    view[:3, 3] = -R.T @ t
    return view
