"""Deformable instance nodes: port of `node_gaussians` from
bilateral_driving_tpu/scene/deformable.py.

RigidNodes whose local points first deform through the conditional deform
network of (x / instance size, t, instance code).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G
from . import rigid


class DeformableConfig(NamedTuple):
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    deform_quat: bool = True
    deform_scale: bool = True


def node_gaussians(params, statics, mask, cam_origin, step: int, frame: int,
                   num_frames: int, t: float, in_test_set: bool = False,
                   cfg: DeformableConfig = DeformableConfig()) -> G.Gaussians:
    """params carries the Gaussian dict, pose tracks, `instance_embeds`
    (I, E) and `deform_net` (a models.deform.DeformNetwork)."""
    pid = statics["point_ids"].long()
    sizes = statics["instances_size"][pid]
    x_norm = params["means"] / torch.clamp(sizes, min=1e-6)
    emb = params["instance_embeds"][pid]
    tt = torch.full((x_norm.shape[0], 1), float(t), dtype=x_norm.dtype,
                    device=x_norm.device)
    d_xyz, d_quat, d_scale = params["deform_net"](x_norm, tt, emb)

    local_means = params["means"] + d_xyz
    local_quats = params["quats"]
    if d_quat is not None and cfg.deform_quat:
        local_quats = local_quats + d_quat
    log_scales = params["log_scales"]
    if d_scale is not None and cfg.deform_scale:
        log_scales = log_scales + d_scale

    q_ins, t_ins, valid = rigid._frame_pose(params, statics, frame,
                                            num_frames, in_test_set)
    means, quats = rigid.transform_to_world(
        local_means, local_quats, statics["point_ids"], q_ins, t_ins)
    rgbs = G.sh_colors(means, params["sh_dc"], params["sh_rest"], cam_origin,
                       step, cfg.sh_degree_interval, cfg.sh_degree)
    opac = torch.sigmoid(params["logit_opacities"][:, 0]) * valid[pid] * mask
    return G.Gaussians(means, torch.exp(log_scales), quats, opac, rgbs)
