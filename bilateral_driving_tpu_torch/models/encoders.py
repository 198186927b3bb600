"""MLP, sinusoidal encoding and embedding primitives: port of
bilateral_driving_tpu/models/encoders.py.

An MLP's parameters are {"layers": [{"w": (in, out), "b": (out,)}, ...]},
the JAX package's nesting. Its skip connections are not in the tree (the
JAX package keeps them there as a static leaf): the caller passes them to
mlp_apply, so neither Adam nor a checkpoint sees them. Every random draw
comes from the caller's torch.Generator.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def sinusoidal_encode(x: torch.Tensor, min_deg: int, max_deg: int,
                      use_identity: bool = True) -> torch.Tensor:
    """Positional encoding: scales 2^[min_deg, max_deg) on each input
    dimension, sin and cos, the raw input first."""
    if min_deg == max_deg:
        return x
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * scales[:, None]             # (..., L, D)
    enc = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-2))
    enc = enc.reshape(*x.shape[:-1], -1)
    if use_identity:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def sinusoidal_dim(in_dim: int, min_deg: int, max_deg: int,
                   use_identity: bool = True) -> int:
    return in_dim * (2 * (max_deg - min_deg) + (1 if use_identity else 0))


def mlp_init(generator: torch.Generator, in_dim: int, out_dim: int,
             num_layers: int, hidden: int, skips: Sequence[int] = (),
             zero_init_last: bool = False, zero_init_all: bool = False,
             device="cuda"):
    """Kaiming-uniform layers (torch Linear's default bound 1/sqrt(in)) of
    an MLP whose layers in `skips` also take the input; `zero_init_last`
    zeroes the last layer, `zero_init_all` every layer."""
    params = []
    d = in_dim
    for i in range(num_layers):
        di = d + (in_dim if i in skips else 0)
        do = hidden if i < num_layers - 1 else out_dim
        bound = 1.0 / math.sqrt(di)
        w, b = ((torch.rand(shape, generator=generator,
                            device=generator.device) * 2.0 - 1.0) * bound
                for shape in ((di, do), (do,)))
        if zero_init_all or (zero_init_last and i == num_layers - 1):
            w, b = torch.zeros_like(w), torch.zeros_like(b)
        params.append({"w": w.to(device), "b": b.to(device)})
        d = do
    return {"layers": params}


def mlp_apply(params, x: torch.Tensor,
              skips: Sequence[int] = ()) -> torch.Tensor:
    """ReLU between layers, none after the last; a layer in `skips` gets
    the input concatenated to its own."""
    inp = x
    layers = params["layers"]
    for i, layer in enumerate(layers):
        if i in skips:
            x = torch.cat([x, inp], dim=-1)
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def embedding_init(num: int, dim: int, generator: torch.Generator,
                   device="cuda") -> torch.Tensor:
    """(num, dim) standard-normal codes."""
    return torch.randn((num, dim), generator=generator,
                       device=generator.device).to(device)
