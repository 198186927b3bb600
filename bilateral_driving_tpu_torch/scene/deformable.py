"""Deformable Gaussians: port of bilateral_driving_tpu/scene/deformable.py.

Two reference models:
  * the DeformableGS background (`deformgs_gaussians`, reference
    project/models/gaussians/deformgs.py): canonical Gaussians plus the
    offsets of a DeformNetwork(x, t) on MeRF-contracted coordinates;
  * DeformableNodes (`node_gaussians`): RigidNodes whose local points
    first deform through the conditional deform network of
    (x / instance size, t, instance code).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G
from ..core.indexing import take_rows
from ..core.transforms import quat_normalize
from . import rigid


class DeformableConfig(NamedTuple):
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    deform_quat: bool = True
    deform_scale: bool = True


def contract(x: torch.Tensor) -> torch.Tensor:
    """MeRF contraction (deformgs.py:25-40) in the max norm: identity
    inside the unit cube, (2 - 1/|x|) x/|x| outside."""
    mag = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                      min=1e-8)
    return torch.where(mag <= 1.0, x, (2.0 - 1.0 / mag) * (x / mag))


def linear_noise(step, noise_base: float, total_steps: float):
    """AST noise annealing (deformgs get_linear_noise_func,
    deformgs.py:42)."""
    return noise_base * max(1.0 - step / total_steps, 0.0)


def deformgs_gaussians(params, net, mask, cam_origin, step: int, t: float,
                       aabb_center, aabb_scale,
                       cfg: DeformableConfig = DeformableConfig(),
                       ast_noise: float = 0.0) -> G.Gaussians:
    """Canonical parameters plus the offsets of `net` (a
    models.deform.DeformNetwork) at the contracted, AABB-normalized means
    and time t, over every slot of the capacity."""
    xc = contract((params["means"] - aabb_center) / aabb_scale)
    tt = torch.full((xc.shape[0], 1), float(t) + ast_noise, dtype=xc.dtype,
                    device=xc.device)
    d_xyz, d_quat, d_scale = net(xc, tt)
    means = params["means"] + d_xyz
    quats = params["quats"] if d_quat is None else params["quats"] + d_quat
    log_scales = params["log_scales"]
    if d_scale is not None:
        log_scales = log_scales + d_scale
    rgbs = G.sh_colors(means, params["sh_dc"], params["sh_rest"], cam_origin,
                       step, cfg.sh_degree_interval, cfg.sh_degree)
    opac = torch.sigmoid(params["logit_opacities"][:, 0]) * mask
    # the scale offset is unbounded, as in DeformableNodes below
    return G.Gaussians(means, G.finite_grad_exp(log_scales),
                       quat_normalize(quats), opac, rgbs)


def node_gaussians(params, statics, mask, cam_origin, step: int, frame: int,
                   num_frames: int, t: float, in_test_set: bool = False,
                   cfg: DeformableConfig = DeformableConfig()) -> G.Gaussians:
    """params carries the Gaussian dict, pose tracks, `instance_embeds`
    (I, E) and `deform_net` (a models.deform.DeformNetwork)."""
    pid = statics["point_ids"].long()
    sizes = statics["instances_size"][pid]
    x_norm = params["means"] / torch.clamp(sizes, min=1e-6)
    emb = take_rows(params["instance_embeds"], pid)
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
    # the deformation network's scale offset is unbounded: an overflowed
    # scale is culled by the projection and must get a zero gradient
    return G.Gaussians(means, G.finite_grad_exp(log_scales), quats, opac,
                       rgbs)
