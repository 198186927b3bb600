"""Multi-process set-up: port of bilateral_driving_tpu/parallel/distributed.py.

The JAX package joins N processes into one runtime with
`jax.distributed.initialize`; here each process is one rank of a
torch.distributed process group and owns one device. The backend follows
the device: NCCL for CUDA, gloo for the CPU. Nothing on the machine names a
cluster, so the caller gives the address, the world size and the rank:

    python -m bilateral_driving_tpu_torch.tools.train ... \\
        --coordinator host0:7777 --num_processes 2 --process_id $RANK

The coordinator is process 0's host:port, or a torch init method URL
such as file:///shared/rendezvous, which every process can reach with no
port to agree on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import data_parallel


@dataclasses.dataclass(frozen=True)
class DistConfig:
    coordinator: Optional[str] = None   # "host:port" of process 0, or a URL
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize(cfg: DistConfig, device) -> bool:
    """Join the process group when configured; a no-op otherwise, and when
    the group exists already (a second call is ignored).

    Returns True when more than one process runs."""
    if not dist.is_initialized():
        if cfg.coordinator is None and cfg.num_processes is None:
            return False
        if None in (cfg.coordinator, cfg.num_processes, cfg.process_id):
            raise ValueError("a multi-process run needs --coordinator, "
                             "--num_processes and --process_id")
        device = torch.device(device)
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        url = (cfg.coordinator if "://" in cfg.coordinator
               else f"tcp://{cfg.coordinator}")
        dist.init_process_group(
            backend_for(device), init_method=url,
            world_size=int(cfg.num_processes), rank=int(cfg.process_id))
    return dist.get_world_size() > 1


def global_mesh(device, axis: str = "data") -> data_parallel.Mesh:
    """1-D mesh over every rank of the process group."""
    return data_parallel.make_mesh(device=device, axis=axis)


def host_local_batch_to_global(local_batch, mesh: data_parallel.Mesh):
    """Each rank keeps its own batch: the JAX package assembles a global
    sharded array here, the ranks of a process group need no assembly.
    Moves the batch to the rank's device."""
    return data_parallel.to_device(local_batch, mesh.device)


def process_train_indices(train_indices, seed: int, step: int,
                          mesh: data_parallel.Mesh) -> np.ndarray:
    """This rank's image for the step: every rank draws the same global
    choice and takes its own row (one device per process), so no data
    moves between ranks."""
    rng = np.random.RandomState((seed * 1_000_003 + step) % (2 ** 31 - 1))
    n = mesh.size
    picks = rng.choice(len(train_indices), size=n,
                       replace=len(train_indices) < n)
    return np.asarray(train_indices)[picks[mesh.rank:mesh.rank + 1]]
