"""Scene-graph composition: port of bilateral_driving_tpu/scene/nodes.py.

Every node class turns its parameters into a fixed-capacity
`core.gaussians.Gaussians` in world space for the current frame; dead or
invalid points carry zero opacity, and composition is a concat.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.gaussians import Gaussians

# reference class labels: Background 0, RigidNodes 1, SMPLNodes 2,
# DeformableNodes 3
NODE_CLASS_IDS: Dict[str, int] = {
    "Background": 0,
    "RigidNodes": 1,
    "SMPLNodes": 2,
    "DeformableNodes": 3,
}


def concat_bundles(bundles: Dict[str, Gaussians]):
    """Concat in NODE_CLASS_IDS order; returns (gaussians, labels)."""
    names = [n for n in NODE_CLASS_IDS if n in bundles]
    parts = [bundles[n] for n in names]
    labels = torch.cat([
        torch.full((b.means.shape[0],), NODE_CLASS_IDS[n], dtype=torch.int32,
                   device=b.means.device)
        for n, b in zip(names, parts)])
    merged = Gaussians(*(torch.cat(xs) for xs in zip(*parts)))
    return merged, labels
