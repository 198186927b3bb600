"""Data-parallel training over a torch.distributed process group: port of
bilateral_driving_tpu/parallel/data_parallel.py.

Each rank owns one device and renders one image of the step's batch
through the single-image pipeline, with no communication; the gradients
and statistics are then reduced over the group as the JAX package's
`shard_map` reduces them over its `data` axis:

  mean  the total, the loss dict, every parameter gradient, PSNR
        (the batch average, so learning rates keep their meaning)
  sum   the screen-gradient dummy and num_isects (per-Gaussian densification
        statistics over the batch)
  max   radii and the overflow flag

Every rank then runs the trainer's update (trainer.update_and_refine,
apply_grads_and_refine's body) on the same reduced inputs.
All ranks start from one seed, so `state.generator` draws the same PVG
time offset and the same refinement samples everywhere (the JAX package's
replicated key) and the replicated state stays bit-identical across ranks.
Each reduction is one all_reduce of one flat buffer per dtype, in a fixed
order, so a run repeats.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch
import torch.distributed as dist

from ..train import trainer as trainer_mod


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A group of ranks, one device each, along one axis: where the JAX
    package has a `Mesh`. `group` None is the whole process group."""
    group: Any
    size: int
    rank: int
    device: torch.device
    axis: str = "data"


def make_mesh(n_devices: int | None = None, axis: str = "data", *,
              device) -> Mesh:
    """1-D mesh over the initialised process group's ranks, this rank on
    `device`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (distributed."
                           "maybe_initialize, or tools.train's launcher)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a {axis} mesh of {n_devices} devices needs as "
                         f"many ranks, have {size}")
    return Mesh(None, size, rank, torch.device(device), axis)


def to_device(batch: Dict, device) -> Dict:
    """The batch's tensors on `device`; other values as they are."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def stack_batches(batches: Sequence[Dict]) -> list:
    """The step's per-image batches, one row per rank of the data axis."""
    return list(batches)


def shard_batch(stacked: Sequence[Dict], mesh: Mesh) -> Dict:
    """This rank's row of a stacked batch, on its device."""
    if len(stacked) != mesh.size:
        raise ValueError(f"{len(stacked)} batch rows for a {mesh.axis} "
                         f"mesh of {mesh.size}")
    return to_device(stacked[mesh.rank], mesh.device)


def all_reduce_in_order(tensors: Sequence[torch.Tensor], op, group=None
                        ) -> list:
    """all_reduce every tensor of the list with `op`: one flat buffer per
    dtype, in the list's order. Returns new tensors of the input shapes
    (bool tensors come back as int32)."""
    tensors = [t.to(torch.int32) if t.dtype == torch.bool else t
               for t in tensors]
    out: list = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idxs in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idxs])
        dist.all_reduce(flat, op=op, group=group)
        for i, piece in zip(idxs, flat.split([tensors[i].numel()
                                              for i in idxs])):
            out[i] = piece.view(tensors[i].shape)
    return out


def reduce_grads(total, loss_dict, g_params, psnr, group, size: int,
                 sums: Sequence[torch.Tensor] = (),
                 maxes: Sequence[torch.Tensor] = ()):
    """Mean of the total, the loss dict, the gradients and PSNR over
    `group` (of `size` ranks), sum of `sums`, max of `maxes`; returns
    (total, loss_dict, g_params, psnr, sums, maxes)."""
    keys, names = list(loss_dict), list(g_params)
    means = all_reduce_in_order(
        [total, *(loss_dict[k] for k in keys),
         *(g_params[n] for n in names), psnr], dist.ReduceOp.SUM, group)
    means = [m / size for m in means]
    total, rest = means[0], means[1:]
    loss_dict = dict(zip(keys, rest[:len(keys)]))
    g_params = dict(zip(names, rest[len(keys):len(keys) + len(names)]))
    psnr = rest[-1]
    sums = all_reduce_in_order(sums, dist.ReduceOp.SUM, group) if sums \
        else []
    maxes = all_reduce_in_order(maxes, dist.ReduceOp.MAX, group) if maxes \
        else []
    return total, loss_dict, g_params, psnr, sums, maxes


def parallel_train_step(cfg: trainer_mod.TrainerConfig, statics, mesh: Mesh):
    """A data-parallel train step: this rank's image's gradients, reduced
    over the mesh, then the same update and refinement on every rank.

    Returns step(state, batch) -> (state, metrics), `batch` being this
    rank's row (shard_batch)."""

    def step(state, batch):
        total, loss_dict, outputs, g_params, g_dummy = \
            trainer_mod.compute_grads(cfg, statics, state, batch)
        info = outputs["info"]
        total, loss_dict, g_params, psnr, (g_dummy, num_isects), \
            (radii, overflow) = reduce_grads(
                total, loss_dict, g_params,
                trainer_mod.image_psnr(outputs, batch), mesh.group,
                mesh.size, sums=(g_dummy, info["num_isects"]),
                maxes=(info["radii"], info["overflow"]))
        return trainer_mod.update_and_refine(
            cfg, statics, state, batch["pixels"].shape[:2], total, loss_dict,
            g_params, g_dummy, radii, overflow.bool(), num_isects, psnr)

    return step
