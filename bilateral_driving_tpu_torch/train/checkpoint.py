"""Checkpoint and resume by torch.save: port of
bilateral_driving_tpu/train/checkpoint.py (which uses orbax).

A checkpoint holds the whole TrainerState: parameters (a deformation
network as its state_dict), aux, masks, density statistics, the Adam state,
`step`, `updates` and the refinement generator's state, plus whatever loop
state the caller adds (`extra`: the CLI's image sampler and intersection
capacity). Restoring writes into a template state built by the same
configuration, in place where the optimizer holds the tensors, so a resumed
run continues exactly as an uninterrupted one.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from . import density, trainer as trainer_mod


def _plain(tree):
    """The state's trees with tensors on the CPU and modules as
    state_dicts."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    if isinstance(tree, torch.nn.Module):
        return {k: v.detach().cpu() for k, v in tree.state_dict().items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _copy_into(template, saved, path=""):
    """Write saved values into the template's tensors and modules."""
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError(f"checkpoint keys differ at {path or '/'}: "
                             f"{sorted(set(template) ^ set(saved))}")
        for k in template:
            _copy_into(template[k], saved[k], f"{path}/{k}")
    elif isinstance(template, (list, tuple)):
        for i, (t, s) in enumerate(zip(template, saved, strict=True)):
            _copy_into(t, s, f"{path}/{i}")
    elif isinstance(template, torch.nn.Module):
        template.load_state_dict(saved)
    elif isinstance(template, torch.Tensor):
        if template.shape != saved.shape or template.dtype != saved.dtype:
            raise ValueError(f"checkpoint {path}: {saved.dtype} "
                             f"{tuple(saved.shape)} into {template.dtype} "
                             f"{tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(saved)
    elif template != saved:
        raise ValueError(f"checkpoint {path}: {saved!r} != {template!r}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def save_checkpoint(ckpt_dir: str, state: trainer_mod.TrainerState,
                    step: Optional[int] = None,
                    extra: Optional[dict] = None) -> str:
    """Write `checkpoint_<step>.pt` (the state's step by default) into
    ckpt_dir, replacing one of the same step."""
    step = int(state.step) if step is None else step
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"checkpoint_{step}.pt")
    blob = {
        "params": _plain(state.params),
        "aux": _plain(state.aux),
        "masks": _plain(state.masks),
        "stats": {k: list(_plain(tuple(s))) for k, s in state.stats.items()},
        "opt": state.opt.state_dict(),
        "step": int(state.step),
        "updates": int(state.updates),
        "generator": state.generator.get_state(),
        "extra": extra or {},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [d for d in os.listdir(ckpt_dir)
             if d.startswith("checkpoint_") and d.endswith(".pt")]
    if not cands:
        return None
    latest = max(cands, key=lambda d: int(d[len("checkpoint_"):-3]))
    return os.path.join(ckpt_dir, latest)


def restore_checkpoint(path: str, template: trainer_mod.TrainerState):
    """Restore into `template` (built by the same configuration) in place.
    Returns (state, extra)."""
    # the file holds numpy generator states beside tensors: written by
    # save_checkpoint, so it is unpickled in full
    blob = torch.load(path, map_location="cpu", weights_only=False)
    dev = template.masks["Background"].device
    _copy_into(template.params, blob["params"])
    template.aux = _to(blob["aux"], dev)
    template.masks = _to(blob["masks"], dev)
    template.stats = {k: density.DensityStats(*(x.to(dev) for x in s))
                      for k, s in blob["stats"].items()}
    template.opt.load_state_dict(blob["opt"])
    template.step = blob["step"]
    template.updates = blob["updates"]
    template.generator.set_state(blob["generator"])
    return template, blob["extra"]
