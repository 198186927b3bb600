"""Rigid vehicle nodes: port of the render half of
bilateral_driving_tpu/scene/rigid.py.

Gaussians live in instance-local frames; per-frame, per-instance pose
tracks (quats (F, I, 4), trans (F, I, 3)) carry them to world. Test views
interpolate the neighbouring frames' poses where both are valid; frames
where an instance is not valid give its points zero opacity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G, transforms


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
