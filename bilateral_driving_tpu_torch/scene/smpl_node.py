"""SMPL pedestrian nodes: port of bilateral_driving_tpu/scene/smpl_node.py.

Per instance V canonical Gaussians on or near the SMPL body, per-frame
root quaternions (F, I, 1, 4), joint quaternions (F, I, 23, 4) and
translations (F, I, 3); linear blend skinning carries points and
orientations to the world, with the mesh's skinning weights or, with the
voxel deformer (scene/voxel_deformer.py), the weights of its learned
voxel at each canonical point. The point count is fixed at I V (no
densification); KNN smoothness regularisers keep neighbours alike. Test
views slerp the neighbouring frames' poses. Every instance is computed
in every frame and an invalid one gets zero opacity, so the shapes (and
the gradients' leaves) never change.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G, transforms
from . import smpl_model, voxel_deformer as vd


class SMPLConfig(NamedTuple):
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    knn_neighbors: int = 5
    use_voxel_deformer: bool = False
    ball_gaussians: bool = False


def _frame_theta(params, statics, frame: int, num_frames: int,
                 in_test_set: bool):
    """(I, 24, 4) unit joint quaternions, (I, 3) translations and (I,)
    validity at `frame`; on test views the two neighbouring frames' poses
    are slerped where both are valid."""
    root = params["instances_quats"]       # (F, I, 1, 4)
    body = params["smpl_quats"]            # (F, I, 23, 4)
    trans = params["instances_trans"]      # (F, I, 3)
    fv = statics["instances_fv"]           # (F, I)
    th_cur = torch.cat([root[frame], body[frame]], dim=1)
    t_cur = trans[frame]
    valid = fv[frame]
    if in_test_set:
        prev = min(max(frame - 1, 0), num_frames - 1)
        nxt = min(max(frame + 1, 0), num_frames - 1)
        can = frame - 1 >= 0 and frame + 1 < num_frames
        both = fv[prev] & fv[nxt] & can
        th_int = transforms.quat_slerp(
            torch.cat([root[prev], body[prev]], dim=1),
            torch.cat([root[nxt], body[nxt]], dim=1), 0.5)
        t_int = 0.5 * (trans[prev] + trans[nxt])
        th_cur = torch.where(both[:, None, None], th_int, th_cur)
        t_cur = torch.where(both[:, None], t_int, t_cur)
    return transforms.quat_normalize(th_cur), t_cur, valid


def gaussians(params, statics, mask, cam_origin, step: int, frame: int,
              num_frames: int, in_test_set: bool = False,
              cfg: SMPLConfig = SMPLConfig(),
              vd_statics: vd.VoxelDeformerStatics | None = None
              ) -> G.Gaussians:
    """statics: template (smpl_model.SMPLTemplate), instances_fv (F, I)
    and point_ids (I V,). params: the Gaussian dict plus instances_quats,
    smpl_quats and instances_trans, and with cfg.use_voxel_deformer
    voxel_w_correction, queried through `vd_statics`."""
    template: smpl_model.SMPLTemplate = statics["template"]
    num_inst = template.j_canonical.shape[0]
    V = params["means"].shape[0] // num_inst
    theta, t_ins, valid = _frame_theta(params, statics, frame, num_frames,
                                       in_test_set)
    A = smpl_model.skinning_transforms(template, theta)     # (I, 24, 4, 4)
    means_i = params["means"].reshape(num_inst, V, 3)
    if cfg.use_voxel_deformer and vd_statics is not None:
        W = vd.query_weights(vd_statics, params, means_i)
    else:
        W = template.lbs_weights                             # (I, V, 24)
    posed, R = smpl_model.lbs_apply(W, A, means_i)
    world_means = (posed + t_ins[:, None, :]).reshape(-1, 3)
    quats_i = transforms.quat_normalize(params["quats"]).reshape(
        num_inst, V, 4)
    world_quats = transforms.quat_mult(transforms.rotmat_to_quat(R),
                                       quats_i).reshape(-1, 4)
    rgbs = G.sh_colors(world_means, params["sh_dc"], params["sh_rest"],
                       cam_origin, step, cfg.sh_degree_interval,
                       cfg.sh_degree)
    opac = (torch.sigmoid(params["logit_opacities"][:, 0])
            * valid[statics["point_ids"].long()] * mask)
    if cfg.ball_gaussians:
        scales = torch.exp(params["log_scales"][:, :1]).expand(-1, 3)
    else:
        scales = torch.exp(params["log_scales"])
    return G.Gaussians(world_means, scales,
                       transforms.quat_normalize(world_quats), opac, rgbs)


def compute_knn(means: torch.Tensor, num_inst: int, k: int) -> torch.Tensor:
    """(I, V, k) int64 indices of each canonical point's k nearest points of
    its instance (itself included): d^2 = |p|^2 - 2 p.q + |q|^2 in the
    points' dtype, one instance at a time."""
    V = means.shape[0] // num_inst
    out = []
    for pts in means.reshape(num_inst, V, 3):
        sq = torch.sum(pts * pts, dim=-1, keepdim=True)
        d2 = sq - 2.0 * pts @ pts.T + sq.T
        out.append(torch.topk(-d2, k, dim=-1).indices)
    return torch.stack(out)


def knn_reg_loss(params, statics, nn_ind: torch.Tensor, frame: int,
                 reg_cfg: dict, cfg: SMPLConfig = SMPLConfig()) -> dict:
    """KNN smoothness of sh_dc, sh_rest, opacity, scale and quats (the
    population standard deviation over each point's neighbours, averaged
    over the instances valid at `frame`), and the offset from the mesh
    init position (`x_offset`)."""
    valid = statics["instances_fv"][frame].to(torch.float32)
    num_inst = valid.shape[0]
    V = params["means"].shape[0] // num_inst
    n_valid = torch.clamp(torch.sum(valid), min=1e-6)
    inst = torch.arange(num_inst, device=nn_ind.device)[:, None, None]
    idx = nn_ind.long()

    def std_term(flat_values, dim):
        gathered = flat_values.reshape(num_inst, V, dim)[inst, idx]
        std = torch.std(gathered, dim=2, correction=0)      # (I, V, dim)
        return torch.sum(std.mean(dim=(1, 2)) * valid) / n_valid

    losses = {}
    kr = reg_cfg.get("knn_reg")
    if kr is not None:
        losses["knn_reg_dc"] = std_term(params["sh_dc"][:, 0, :], 3) * \
            kr.get("lambda_std_shs_dc", 0.0)
        rest = params["sh_rest"].reshape(params["sh_rest"].shape[0], -1)
        losses["knn_reg_rest"] = std_term(rest, rest.shape[-1]) * \
            kr.get("lambda_std_shs_rest", 0.0)
        losses["knn_reg_o"] = std_term(
            torch.sigmoid(params["logit_opacities"]), 1) * \
            kr.get("lambda_std_o", 0.0)
        sdim = 1 if cfg.ball_gaussians else 3
        losses["knn_reg_s"] = std_term(
            torch.exp(params["log_scales"][:, :sdim]), sdim) * \
            kr.get("lambda_std_s", 0.0)
        losses["knn_reg_q"] = std_term(params["quats"], 4) * \
            kr.get("lambda_std_q", 0.0)
    xo = reg_cfg.get("x_offset")
    if xo is not None and "on_mesh_x" in statics:
        dd = (params["means"] - statics["on_mesh_x"]).reshape(num_inst, V, 3)
        # the clamp keeps the gradient finite at zero offset
        dx = torch.sqrt(torch.clamp(torch.sum(dd * dd, dim=-1), min=1e-16))
        losses["x_offset"] = (torch.sum(dx.mean(dim=1) * valid) / n_valid
                              * xo["w"])
    return losses


def joint_smoothness_loss(params, statics, frame: int, num_frames: int,
                          w: float) -> torch.Tensor:
    """Second-order smoothness of the posed joints over frames frame - 1,
    frame and frame + 1: |(j_next - j_cur) - (j_cur - j_prev)| averaged
    over joints and over the instances valid in all three. The gate is
    frame - 1 > 0, as the reference has it (the test-view slerp's is
    frame - 1 >= 0)."""
    template: smpl_model.SMPLTemplate = statics["template"]
    prev = min(max(frame - 1, 0), num_frames - 1)
    nxt = min(max(frame + 1, 0), num_frames - 1)
    can = float(frame - 1 > 0 and frame + 1 < num_frames)

    def joints_at(f):
        theta = torch.cat([params["instances_quats"][f],
                           params["smpl_quats"][f]], dim=1)
        rot = transforms.quat_to_rotmat(transforms.quat_normalize(theta))
        J, _ = smpl_model.batch_rigid_transform(
            rot, template.j_canonical, template.parents)
        return J + params["instances_trans"][f][:, None, :]

    j_prev, j_cur, j_next = joints_at(prev), joints_at(frame), joints_at(nxt)
    fv = statics["instances_fv"]
    valid = (fv[prev] & fv[frame] & fv[nxt]).to(torch.float32)
    acc = torch.abs((j_next - j_cur) - (j_cur - j_prev))
    per_inst = acc.mean(dim=(1, 2))
    return can * w * torch.sum(per_inst * valid) / torch.clamp(
        torch.sum(valid), min=1e-6)
