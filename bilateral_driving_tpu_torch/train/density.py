"""Adaptive density control on fixed-capacity classes: port of
bilateral_driving_tpu/train/density.py, PVG's temporal densification and
position-aware size factor included.

Each class keeps a fixed capacity and a liveness mask, so densification is
array work: per-point statistics (accumulated screen-gradient norm,
visibility count, largest screen radius), culling into the mask, split and
duplicate children placed into dead slots by rank (capacity overflow drops
the extras), an opacity reset, and the Adam moments of every touched slot
zeroed in the optimizer's state instead of optimizer surgery.

Split offsets (and PVG children's times) are drawn from an explicit
torch.Generator; the JAX package draws them from jax.random, so the two
agree on everything but those samples.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import transforms

# per-point keys of a class's parameter dict (leading dim == capacity);
# anything else (pose tracks, instance codes, networks) is left alone
PER_POINT_KEYS = frozenset({
    "means", "log_scales", "quats", "logit_opacities", "sh_dc", "sh_rest",
    "taus", "log_betas", "velocity",
})


class DensityConfig(NamedTuple):
    densify_grad_thresh: float = 0.0005
    densify_size_thresh: float = 0.003
    n_split_samples: int = 2
    cull_alpha_thresh: float = 0.005
    cull_scale_thresh: float = 0.5
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4000
    stop_split_at: int = 15000
    reset_alpha_interval: int = 3000
    reset_alpha_value: float = 0.01
    refine_interval: int = 100
    warmup_steps: int = 500
    # PVG temporal densification (reference pvg.py:149-199)
    densify_t_grad_thresh: float = 0.002
    densify_t_size_thresh: float = 0.01
    no_time_split: bool = True
    densify_until_num_points: int = 3_000_000


class DensityStats(NamedTuple):
    grad_norm: torch.Tensor   # (C,) accumulated screen-gradient norms
    vis_count: torch.Tensor   # (C,)
    max_radii: torch.Tensor   # (C,) largest radius / image size
    t_grad: torch.Tensor      # (C,) accumulated |dL/dtau| (PVG; zeros
    #                           for classes without a time axis)

    @staticmethod
    def zeros(capacity: int, device="cuda"):
        return DensityStats(*(torch.zeros(capacity, device=device)
                              for _ in range(4)))


def accumulate_stats(stats: DensityStats, grad2d, radii,
                     last_size: float, t_grad=None) -> DensityStats:
    """grad2d (C, 2) this step's screen gradients, radii (C,) this step's
    pixel radii, t_grad (C,) this step's dL/dtau (PVG only)."""
    vis = (radii > 0).to(torch.float32)
    g = torch.linalg.vector_norm(grad2d, dim=-1) * vis
    return DensityStats(
        grad_norm=stats.grad_norm + g,
        vis_count=stats.vis_count + vis,
        max_radii=torch.maximum(stats.max_radii,
                                radii.to(torch.float32) / last_size),
        t_grad=(stats.t_grad if t_grad is None
                else stats.t_grad + torch.abs(t_grad) * vis))


def _place(data: dict, occupied, new_vals: dict, want):
    """Write the rows of new_vals that `want` selects into free slots
    (~occupied), in rank order. Returns (data, placed mask, dropped)."""
    cap = occupied.shape[0]
    dev = occupied.device
    want_rank = torch.cumsum(want.long(), 0) - 1
    free = ~occupied
    free_rank = torch.cumsum(free.long(), 0) - 1
    n_free = free.sum()
    slot_of_rank = torch.zeros(cap, dtype=torch.long, device=dev)
    slot_of_rank[free_rank[free]] = torch.nonzero(free).squeeze(1)
    ok = want & (want_rank < n_free)
    src = torch.nonzero(ok).squeeze(1)
    dest = slot_of_rank[want_rank[src]]
    out = {}
    for k, v in data.items():
        o = v.clone()
        o[dest] = new_vals[k][src]
        out[k] = o
    placed = torch.zeros(cap, dtype=torch.bool, device=dev)
    placed[dest] = True
    return out, placed, want.sum() - ok.sum()


def _gamma(means, scene_origin, scene_scale: float):
    """PVG's position-aware size factor (pvg.py:90-98): points far from
    the scene origin may be proportionally larger."""
    origin = torch.tensor(scene_origin, dtype=means.dtype,
                          device=means.device)
    g = torch.linalg.vector_norm(means - origin, dim=-1) * scene_scale - 1.0
    return torch.where(g <= 1.0, torch.ones_like(g), g) / scene_scale


def refine(generator: torch.Generator, params: dict, aux: dict, alive,
           stats: DensityStats, step: int, scene_scale: float,
           cfg: DensityConfig, num_train_images: int = 1, extra_cull=None,
           pvg_cycle: float | None = None,
           scene_origin: tuple = (0.0, 0.0, 0.0)):
    """One refinement pass over a class. `params`: the class's parameter
    dict (per-point keys are refined, the rest pass through); `aux`:
    per-point arrays copied to children (point_ids); `extra_cull`: a
    class-specific cull mask; `pvg_cycle`: set for a PVG class, which
    turns on temporal densification, the position-aware size factor
    around `scene_origin` and densify_until_num_points. Returns (params,
    aux, alive, touched, info), new tensors throughout."""
    cap = alive.shape[0]
    mask_dtype = alive.dtype
    alive = alive.bool()
    pt = {k: v for k, v in params.items() if k in PER_POINT_KEYS}
    rest = {k: v for k, v in params.items() if k not in PER_POINT_KEYS}
    data = {**pt, **{f"aux/{k}": v for k, v in aux.items()}}
    is_pvg = pvg_cycle is not None and "taus" in pt

    scaling = torch.exp(pt["log_scales"])
    max_scale = torch.amax(scaling, dim=-1)
    avg_grad = stats.grad_norm / torch.clamp(stats.vis_count, min=1.0)
    high_grads = (avg_grad > cfg.densify_grad_thresh) & alive
    gamma = _gamma(pt["means"], scene_origin, scene_scale) if is_pvg \
        else 1.0

    reset_interval = cfg.reset_alpha_interval
    gate = max(num_train_images, cfg.refine_interval)
    do_densify = (step < cfg.stop_split_at
                  and (step % reset_interval) > gate
                  and step > cfg.warmup_steps)
    if is_pvg:
        # stop growing a saturated PVG class (pvg.py:160)
        do_densify = do_densify and int(alive.sum()) < \
            cfg.densify_until_num_points

    big = max_scale > cfg.densify_size_thresh * scene_scale * gamma
    screen_big = stats.max_radii > cfg.split_screen_size
    splits = big | (screen_big & (step < cfg.stop_screen_size_at))
    dups = ~big
    if is_pvg:
        # temporal candidates (pvg.py:166-199): a high |dL/dtau| splits
        # along time where the temporal extent is past the threshold and
        # duplicates otherwise
        scaling_t = torch.exp(pt["log_betas"])
        avg_t_grad = stats.t_grad / torch.clamp(stats.vis_count, min=1.0)
        high_t = (avg_t_grad > cfg.densify_t_grad_thresh) & alive
        high_grads = high_grads | high_t
        splits_t = (scaling_t > cfg.densify_t_size_thresh) & high_t
        splits = splits | splits_t
        dups = dups | ((scaling_t <= cfg.densify_t_size_thresh) & high_t)
    splits = splits & high_grads & do_densify
    dups = dups & high_grads & do_densify

    # split children: samples of the parent Gaussian at 1/1.6 its scale
    occupied = alive
    placed_any = torch.zeros(cap, dtype=torch.bool, device=alive.device)
    new_log_scale = torch.log(torch.clamp(scaling / 1.6, min=1e-10))
    # a t-triggered PVG split leaves the spatial scale as it is
    # (pvg.py:339-347)
    child_log_scale = (torch.where(big[:, None], new_log_scale,
                                   pt["log_scales"]) if is_pvg
                       else new_log_scale)
    rot = transforms.quat_to_rotmat(pt["quats"])
    n_dropped = torch.zeros((), dtype=torch.long, device=alive.device)
    for _ in range(cfg.n_split_samples):
        eps = torch.randn((cap, 3), generator=generator,
                          device=generator.device).to(alive.device)
        offset = torch.einsum("nij,nj->ni", rot, scaling * eps)
        child = dict(data)
        child["means"] = pt["means"] + offset
        child["log_scales"] = child_log_scale
        if is_pvg:
            # children draw a time from the parent's temporal Gaussian and
            # ride the vibration to the matching position (pvg.py:329-337)
            t_eps = torch.randn((cap,), generator=generator,
                                device=generator.device).to(
                                    alive.device) * scaling_t
            child["taus"] = pt["taus"] + t_eps
            v_eff = pt["velocity"] * torch.exp(
                -0.5 * scaling_t / pvg_cycle)[:, None]
            child["means"] = child["means"] + v_eff * t_eps[:, None]
            child["log_betas"] = (
                pt["log_betas"] if cfg.no_time_split
                else torch.where(splits_t, torch.log(torch.clamp(
                    scaling_t / 1.6, min=1e-10)), pt["log_betas"]))
        data, placed, dropped = _place(data, occupied, child, splits)
        occupied = occupied | placed
        placed_any = placed_any | placed
        n_dropped = n_dropped + dropped
    data["log_scales"] = torch.where(splits[:, None], new_log_scale,
                                     data["log_scales"])

    # duplicate children: copies
    data, placed, dropped = _place(data, occupied, dict(data), dups)
    occupied = occupied | placed
    placed_any = placed_any | placed
    n_dropped = n_dropped + dropped
    alive = occupied

    # cull
    opac = torch.sigmoid(data["logit_opacities"][:, 0])
    culls = opac < cfg.cull_alpha_thresh
    # PVG's gamma again, over the grown set (pvg.py:169-174)
    cull_gamma = (_gamma(data["means"], scene_origin, scene_scale)
                  if is_pvg else 1.0)
    toobig_world = (torch.amax(torch.exp(data["log_scales"]), dim=-1)
                    > cfg.cull_scale_thresh * scene_scale * cull_gamma)
    toobig_screen = stats.max_radii > cfg.cull_screen_size
    if step > reset_interval:
        culls = culls | toobig_world | (
            toobig_screen & (step < cfg.stop_screen_size_at))
    if extra_cull is not None:
        culls = culls | extra_cull
    do_cull = (step % reset_interval) > gate
    n_culled = (culls & alive).sum() if do_cull else torch.zeros_like(
        n_dropped)
    if do_cull:
        alive = alive & ~culls

    # opacity reset
    do_reset = (step % reset_interval) == cfg.refine_interval
    if do_reset:
        data["logit_opacities"] = torch.clamp(
            data["logit_opacities"], max=_reset_logit(cfg.reset_alpha_value))

    new_params = {**rest, **{k: v for k, v in data.items()
                             if not k.startswith("aux/")}}
    new_aux = {k[4:]: v for k, v in data.items() if k.startswith("aux/")}
    info = {"splits": splits.sum(), "dups": dups.sum(), "culled": n_culled,
            "dropped": n_dropped, "opacity_reset": do_reset}
    return new_params, new_aux, alive.to(mask_dtype), placed_any, info


def _reset_logit(alpha: float) -> float:
    """log(alpha / (1 - alpha)) in float32, as the JAX package evaluates
    it."""
    return float(np.log(np.float32(alpha / (1 - alpha))))


def reset_moments(optimizer: torch.optim.Optimizer, class_params: dict,
                  touched, also_key: str | None = None):
    """Zero the Adam moments at the `touched` slots of every tensor of the
    class's parameter dict whose leading dimension is the capacity (only
    `also_key`'s when given) — the masked replacement for moving slots in
    and out of the optimizer."""
    cap = touched.shape[0]
    for k, p in class_params.items():
        if not isinstance(p, torch.Tensor) or p.dim() < 1 or p.shape[0] != cap:
            continue
        if also_key is not None and k != also_key:
            continue
        state = optimizer.state.get(p)
        if not state:
            continue
        for m in ("exp_avg", "exp_avg_sq"):
            state[m][touched] = 0.0
