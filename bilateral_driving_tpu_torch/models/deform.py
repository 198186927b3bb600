"""Conditional deformation network of DeformableNodes: port of
bilateral_driving_tpu/models/deform.py.

NeRF positional encodings of (x, t) plus a per-instance code, an 8 x 256
ReLU trunk whose skip at depth // 2 concatenates the encoded input after
the activation, and heads for position offset, quaternion delta and scale
delta.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


def nerf_encode(x: torch.Tensor, multires: int) -> torch.Tensor:
    """Identity + sin/cos at 2^[0..m-1], interleaved per frequency."""
    outs = [x]
    for i in range(multires):
        f = 2.0 ** i
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


def nerf_dim(d: int, multires: int) -> int:
    return d * (1 + 2 * multires)


class DeformNetwork(nn.Module):
    """embed_dim 0 gives DeformNetwork, > 0 ConditionalDeformNetwork."""

    def __init__(self, depth: int = 8, width: int = 256, embed_dim: int = 0,
                 x_multires: int = 10, t_multires: int = 10,
                 deform_quat: bool = True, deform_scale: bool = True):
        super().__init__()
        self.x_multires = x_multires
        self.t_multires = t_multires
        in_dim = nerf_dim(3, x_multires) + nerf_dim(1, t_multires) + embed_dim
        self.skips = (depth // 2,)
        layers = []
        d = in_dim
        for i in range(depth):
            layers.append(nn.Linear(d, width))
            d = width + (in_dim if i in self.skips else 0)
        self.trunk = nn.ModuleList(layers)
        self.heads = nn.ModuleDict({"warp": nn.Linear(d, 3)})
        if deform_quat:
            self.heads["quat"] = nn.Linear(d, 4)
        if deform_scale:
            self.heads["scale"] = nn.Linear(d, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases, drawn from
        `generator`."""
        for lin in [*self.trunk, *self.heads.values()]:
            bound = 1.0 / math.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                u = torch.rand(p.shape, generator=generator,
                               device=generator.device)
                p.copy_((u * 2.0 - 1.0) * bound)
        return self

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                condition: torch.Tensor | None = None):
        """(d_xyz, d_quat | None, d_scale | None); x (..., 3), t (..., 1)."""
        parts = [nerf_encode(x, self.x_multires),
                 nerf_encode(t, self.t_multires)]
        if condition is not None:
            parts.append(condition)
        inp = torch.cat(parts, dim=-1)
        h = inp
        for i, layer in enumerate(self.trunk):
            h = F.relu(layer(h))
            if i in self.skips:
                h = torch.cat([inp, h], dim=-1)
        heads = self.heads
        return (heads["warp"](h),
                heads["quat"](h) if "quat" in heads else None,
                heads["scale"](h) if "scale" in heads else None)
