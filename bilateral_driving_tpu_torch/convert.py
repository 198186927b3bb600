"""Carry a scene from the JAX package's structures into the port's.

The JAX trainer keeps `params`, `statics`, `aux` and `masks` as nested dicts
and lists of arrays; the port keeps the same nesting with tensors, except
that a deformation network (`deform_net`: trunk/heads dicts of (in, out)
weight matrices) becomes a models.deform.DeformNetwork. Inputs are numpy
arrays (np.asarray of the JAX leaves); nothing of JAX is imported here.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.deform import DeformNetwork


def _meta(meta) -> dict:
    """The static metadata of a JAX deform net (an object holding a dict in
    `.value`, or the dict itself)."""
    return getattr(meta, "value", meta)


def deform_net_from_jax(tree, device) -> DeformNetwork:
    meta = _meta(tree["meta"])
    trunk, heads = tree["trunk"], tree["heads"]
    x_dim = 3 * (1 + 2 * meta["x_multires"])
    t_dim = 1 + 2 * meta["t_multires"]
    in_dim = np.asarray(trunk[0]["w"]).shape[0]
    net = DeformNetwork(
        depth=len(trunk), width=np.asarray(trunk[0]["w"]).shape[1],
        embed_dim=in_dim - x_dim - t_dim, x_multires=meta["x_multires"],
        t_multires=meta["t_multires"], deform_quat="quat" in heads,
        deform_scale="scale" in heads)
    if tuple(meta["skips"]) != net.skips:
        raise ValueError(f"deform net skips {meta['skips']} != {net.skips}")
    with torch.no_grad():
        for lin, layer in zip([*net.trunk, *(net.heads[k] for k in net.heads)],
                              [*trunk, *(heads[k] for k in net.heads)]):
            lin.weight.copy_(torch.from_numpy(np.array(layer["w"]).T))
            lin.bias.copy_(torch.from_numpy(np.array(layer["b"])))
    return net.to(device)


def tree_from_jax(tree, device):
    """Dicts and lists recurse, arrays become tensors of the same dtype."""
    if isinstance(tree, dict):
        return {k: (deform_net_from_jax(v, device) if k == "deform_net"
                    else tree_from_jax(v, device)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_jax(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def scene_from_jax(params, statics, aux, masks, device="cuda"):
    """(params, statics, aux, masks) of the JAX trainer -> the port's."""
    return tuple(tree_from_jax(t, device)
                 for t in (params, statics, aux, masks))
