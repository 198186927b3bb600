"""Rigid vehicle nodes: port of bilateral_driving_tpu/scene/rigid.py
(rendering, the out-of-box cull of refinement, the out-of-box penalty,
the pose tracks' temporal smoothness and the offline instance-editing API:
remove_instances and replace_instances).

Gaussians live in instance-local frames; per-frame, per-instance pose
tracks (quats (F, I, 4), trans (F, I, 3)) carry them to world. Test views
interpolate the neighbouring frames' poses where both are valid; frames
where an instance is not valid give its points zero opacity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G, transforms

POSE_KEYS = ("instances_quats", "instances_trans")


class RigidConfig(NamedTuple):
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    interpolate_test_poses: bool = True


def _frame_pose(params, statics, frame: int, num_frames: int,
                in_test_set: bool):
    """Per-instance (quat, trans, valid) at `frame`; on test views quats
    are slerped at t = 0.5 and translations averaged between the two
    neighbouring frames where both are valid."""
    iq = params["instances_quats"]
    it = params["instances_trans"]
    fv = statics["instances_fv"]
    q_cur, t_cur, valid = iq[frame], it[frame], fv[frame]
    if in_test_set and frame - 1 >= 0 and frame + 1 < num_frames:
        prev, nxt = frame - 1, frame + 1
        both = (fv[prev] & fv[nxt])[:, None]
        q_int = transforms.quat_slerp(iq[prev], iq[nxt], 0.5)
        t_int = 0.5 * (it[prev] + it[nxt])
        q_cur = torch.where(both, q_int, q_cur)
        t_cur = torch.where(both, t_int, t_cur)
    return q_cur, t_cur, valid


def transform_to_world(local_means, local_quats, point_ids, q_ins, t_ins):
    """Apply each point's instance transform."""
    q_ins = transforms.quat_normalize(q_ins)
    R = transforms.quat_to_rotmat(q_ins)                  # (I, 3, 3)
    pid = point_ids.long()
    world_means = torch.einsum("nij,nj->ni", R[pid], local_means) + t_ins[pid]
    world_quats = transforms.quat_mult(
        q_ins[pid], transforms.quat_normalize(local_quats))
    return world_means, world_quats


def gaussians(params, statics, mask, cam_origin, step: int, frame: int,
              num_frames: int, in_test_set: bool = False,
              cfg: RigidConfig = RigidConfig()) -> G.Gaussians:
    """statics: instances_fv (F, I) bool, instances_size (I, 3) and
    point_ids (C,) int32 instance of each point."""
    point_ids = statics["point_ids"]
    q_ins, t_ins, valid = _frame_pose(
        params, statics, frame, num_frames,
        in_test_set and cfg.interpolate_test_poses)
    means, quats = transform_to_world(
        params["means"], params["quats"], point_ids, q_ins, t_ins)
    rgbs = G.sh_colors(means, params["sh_dc"], params["sh_rest"], cam_origin,
                       step, cfg.sh_degree_interval, cfg.sh_degree)
    opac = (torch.sigmoid(params["logit_opacities"][:, 0])
            * valid[point_ids.long()] * mask)
    return G.Gaussians(means, torch.exp(params["log_scales"]), quats, opac,
                       rgbs)


def out_of_bound_mask(params, statics) -> torch.Tensor:
    """Points outside their instance box."""
    sizes = statics["instances_size"][statics["point_ids"].long()]
    return torch.any(torch.abs(params["means"]) > sizes / 2.0, dim=-1)


def remove_instances(statics, mask, remove_ids):
    """The alive mask with every Gaussian of the instance ids in
    `remove_ids` killed: a new tensor of the mask's dtype and capacity.
    statics: a dict holding point_ids (C,), the instance of each slot."""
    pid = statics["point_ids"]
    ids = torch.as_tensor(list(remove_ids), dtype=pid.dtype,
                          device=pid.device)
    return mask * (~torch.isin(pid, ids)).to(mask.dtype)


def replace_instances(params, statics, mask, replace: dict):
    """replace = {target_id: donor_id}: each target instance's Gaussians
    killed and the donor's live rows of every per-point parameter copied,
    in slot order, into the lowest free slots (the target's, then dead
    ones) and tagged with the target's id, so the copy follows the target's
    pose track. The pose tracks stay as they are.

    Returns new (params, statics, mask) tensors on the inputs' device; the
    inputs are not written. Raises ValueError if a donor has more live
    Gaussians than there are free slots."""
    pid = statics["point_ids"].clone()
    alive = mask.bool().clone()
    rows = {k: v.detach().clone() for k, v in params.items()
            if k not in POSE_KEYS}
    for target, donor in replace.items():
        src = alive & (pid == donor)
        alive[alive & (pid == target)] = False
        free = torch.nonzero(~alive)[:, 0]
        n_src = int(src.sum())
        if n_src > free.numel():
            raise ValueError(
                f"replace_instances: donor {donor} has {n_src} points but "
                f"only {free.numel()} free slots remain")
        dst = free[:n_src]
        src_idx = torch.nonzero(src)[:, 0]
        for v in rows.values():
            v[dst] = v[src_idx]
        pid[dst] = target
        alive[dst] = True
    return ({**params, **rows}, {**statics, "point_ids": pid},
            alive.to(mask.dtype))


def temporal_smoothness_loss(params, statics, w_trans: float,
                             w_quat: float) -> torch.Tensor:
    """Squared differences of consecutive frames' instance quaternions and
    translations, over the (frame, instance) pairs observed in both
    frames, divided by their count."""
    fv = statics["instances_fv"]
    iq, it = params["instances_quats"], params["instances_trans"]
    both = (fv[1:] & fv[:-1]).to(iq.dtype)
    n = torch.clamp(torch.sum(both), min=1.0)
    dq = torch.sum((iq[1:] - iq[:-1]) ** 2, dim=-1)
    dt = torch.sum((it[1:] - it[:-1]) ** 2, dim=-1)
    return (w_quat * torch.sum(dq * both) + w_trans * torch.sum(dt * both)) / n


def reg_loss(params, statics, mask, w_out_of_bound: float = 1.0
             ) -> torch.Tensor:
    """Out-of-box penalty: how far each live point lies outside its
    instance's box, summed over the axes, averaged over the live points."""
    sizes = statics["instances_size"][statics["point_ids"].long()]
    excess = torch.clamp(torch.abs(params["means"]) - sizes / 2.0, min=0.0)
    m = mask.to(excess.dtype)
    return (w_out_of_bound * torch.sum(torch.sum(excess, -1) * m)
            / torch.clamp(torch.sum(m), min=1.0))
