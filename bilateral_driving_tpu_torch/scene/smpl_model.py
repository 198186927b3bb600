"""SMPL body model on tensors: port of bilateral_driving_tpu/scene/smpl_model.py.

Shaping (betas -> vertices and joints), the 24-joint kinematic chain,
the canonical da-pose template with its inverse transforms A0^-1, and
linear blend skinning. `load_model` reads the standard SMPL_NEUTRAL.pkl
(a licensed asset the repository does not carry); `synthetic_model` draws
a small random but kinematically valid body from a torch.Generator.
`mesh_init_qso` is the host-side (numpy) mesh-surface initialisation.
"""
from __future__ import annotations

import math
import pickle
from typing import NamedTuple

import numpy as np
import torch

from ..core import transforms

NUM_JOINTS = 24
# the SMPL kinematic tree: parent of each joint
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21)


class SMPLModel(NamedTuple):
    v_template: torch.Tensor     # (V, 3)
    shapedirs: torch.Tensor      # (V, 3, n_betas)
    j_regressor: torch.Tensor    # (24, V)
    lbs_weights: torch.Tensor    # (V, 24)
    parents: tuple               # 24 ints
    faces: np.ndarray            # (F, 3) int64


def load_model(path: str, device="cuda") -> SMPLModel:
    """The standard SMPL pickle (latin1; sparse entries made dense)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    def dense(x):
        return np.asarray(x.todense()) if hasattr(x, "todense") \
            else np.asarray(x)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    return SMPLModel(
        v_template=t(data["v_template"]),
        shapedirs=t(np.asarray(data["shapedirs"])[..., :10]),
        j_regressor=t(dense(data["J_regressor"])),
        lbs_weights=t(data["weights"]),
        parents=tuple(int(i) for i in np.asarray(data["kintree_table"])[0]),
        faces=np.asarray(data["f"], np.int64),
    )


def synthetic_model(generator: torch.Generator, num_verts: int = 512,
                    device="cuda") -> SMPLModel:
    """A random stand-in body: vertices clustered near 24 random joints,
    skinning weights a softmax of their negative squared distances, the
    joint regressor the mean of each joint's vertices. No mesh (faces is
    one row of zeros)."""
    g = generator
    joints = 0.3 * torch.randn((NUM_JOINTS, 3), generator=g,
                               device=g.device)
    assign = torch.randint(0, NUM_JOINTS, (num_verts,), generator=g,
                           device=g.device)
    verts = joints[assign] + 0.05 * torch.randn((num_verts, 3), generator=g,
                                                device=g.device)
    d2 = torch.sum((verts[:, None] - joints[None]) ** 2, dim=-1)
    weights = torch.softmax(-d2 / 0.02, dim=-1)
    onehot = torch.nn.functional.one_hot(assign, NUM_JOINTS).T.float()
    j_reg = onehot / torch.clamp(onehot.sum(1, keepdim=True), min=1.0)
    shapedirs = 0.01 * torch.randn((num_verts, 3, 10), generator=g,
                                   device=g.device)
    to = lambda x: x.to(device)
    return SMPLModel(to(verts), to(shapedirs), to(j_reg), to(weights),
                     SMPL_PARENTS, np.zeros((1, 3), np.int64))


def shape_model(model: SMPLModel, betas: torch.Tensor):
    """betas (B, 10) -> (vertices (B, V, 3), joints (B, 24, 3))."""
    verts = model.v_template[None] + torch.einsum("vcb,nb->nvc",
                                                  model.shapedirs, betas)
    joints = torch.einsum("jv,nvc->njc", model.j_regressor, verts)
    return verts, joints


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents) -> tuple:
    """rot_mats (B, 24, 3, 3), joints (B, 24, 3) -> (posed joints (B, 24,
    3), A (B, 24, 4, 4)): the chain walked joint by joint, A's translation
    taking the canonical joint position out so that A acts on canonical
    points."""
    B = rot_mats.shape[0]
    rel = torch.cat([joints[:, :1],
                     joints[:, 1:] - joints[:, list(parents[1:])]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=rot_mats.dtype,
                          device=rot_mats.device).expand(B, 1, 4)

    def make_T(R, t):
        return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom],
                         dim=-2)

    chains = [make_T(rot_mats[:, 0], rel[:, 0])]
    for i in range(1, len(parents)):
        chains.append(chains[parents[i]] @ make_T(rot_mats[:, i], rel[:, i]))
    chain = torch.stack(chains, dim=1)                  # (B, 24, 4, 4)
    correction = torch.einsum("bjrc,bjc->bjr", chain[..., :3, :3], joints)
    A = torch.cat([torch.cat([chain[..., :3, :3],
                              (chain[..., :3, 3] - correction)[..., None]],
                             dim=-1), chain[..., 3:, :]], dim=-2)
    return chain[..., :3, 3], A


def da_pose_quats(dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The canonical da-pose as 24 wxyz quaternions: joints 1 and 2 rotated
    by +-30 degrees about z."""
    aa = torch.zeros((NUM_JOINTS, 3), dtype=dtype, device=device)
    aa[1, 2] = math.pi / 6
    aa[2, 2] = -math.pi / 6
    return transforms.axis_angle_to_quat(aa)


class SMPLTemplate(NamedTuple):
    """Per-instance canonical template."""
    j_canonical: torch.Tensor      # (B, 24, 3)
    a0_inv: torch.Tensor           # (B, 24, 4, 4)
    verts_canonical: torch.Tensor  # (B, V, 3)
    lbs_weights: torch.Tensor      # (B, V, 24)
    parents: tuple                 # 24 ints


def make_template(model: SMPLModel, betas: torch.Tensor) -> SMPLTemplate:
    """The shaped body posed into the da-pose: A0 of the da-pose, its
    inverse, and the vertices skinned by A0."""
    B = betas.shape[0]
    verts_shaped, joints = shape_model(model, betas)
    quats = da_pose_quats(betas.dtype, betas.device).expand(B, NUM_JOINTS, 4)
    _, A0 = batch_rigid_transform(transforms.quat_to_rotmat(quats), joints,
                                  model.parents)
    T = torch.einsum("vj,bjrc->bvrc", model.lbs_weights, A0)
    verts_cano = (torch.einsum("bvrc,bvc->bvr", T[..., :3, :3], verts_shaped)
                  + T[..., :3, 3])
    return SMPLTemplate(
        j_canonical=joints, a0_inv=torch.linalg.inv(A0),
        verts_canonical=verts_cano,
        lbs_weights=model.lbs_weights[None].expand(
            (B,) + tuple(model.lbs_weights.shape)),
        parents=tuple(model.parents))


def skinning_transforms(template: SMPLTemplate,
                        joint_quats: torch.Tensor) -> torch.Tensor:
    """joint_quats (B, 24, 4) -> A A0^-1 (B, 24, 4, 4)."""
    rot = transforms.quat_to_rotmat(transforms.quat_normalize(joint_quats))
    _, A = batch_rigid_transform(rot, template.j_canonical, template.parents)
    return torch.einsum("bnij,bnjk->bnik", A, template.a0_inv)


def lbs_apply(W: torch.Tensor, A: torch.Tensor, points: torch.Tensor):
    """Skin canonical points: W (B, N, 24), A (B, 24, 4, 4), points
    (B, N, 3) -> (posed points (B, N, 3), per-point rotation (B, N, 3,
    3))."""
    T = torch.einsum("bnj,bjrc->bnrc", W, A)
    R = T[..., :3, :3]
    return torch.einsum("bnij,bnj->bni", R, points) + T[..., :3, 3], R


def mesh_init_qso(verts: np.ndarray, faces: np.ndarray, seed: int,
                  scale_init_factor: float = 1.0,
                  thickness_init_factor: float = 0.5,
                  max_scale: float = 1.0, min_scale: float = 0.0):
    """Mesh-surface Gaussian geometry (the reference's init_qso_on_mesh):
    per vertex a frame with z along the area-weighted vertex normal and a
    random tangent, as a quaternion; scales the logit of the 1-ring disk
    radius (thickness half of it). `seed` seeds the numpy RandomState of
    the tangents. verts (I, V, 3), faces (F, 3) -> (quats (I V, 4),
    log_scales (I V, 3)), numpy float32."""
    num_inst, V = verts.shape[:2]
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces)
    rng = np.random.RandomState(seed)
    logit = lambda p: np.log(p / (1.0 - p))
    quats_all, scales_all = [], []
    for b in range(num_inst):
        v = verts[b]
        fv = v[faces]                                   # (F, 3, 3)
        fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        area2 = np.linalg.norm(fn, axis=-1)             # 2x triangle area
        normal = np.zeros_like(v)
        vtx_area = np.zeros(V, np.float32)
        for i in range(3):
            np.add.at(normal, faces[:, i], fn)
            np.add.at(vtx_area, faces[:, i], area2 / 2.0 / 3.0)
        nrm = np.linalg.norm(normal, axis=-1, keepdims=True)
        uz = np.where(nrm > 1e-12, normal / np.maximum(nrm, 1e-12),
                      np.array([0.0, 0.0, 1.0], np.float32))
        rand_dir = rng.randn(V, 3).astype(np.float32)
        ux = np.cross(uz, rand_dir)
        ux /= np.maximum(np.linalg.norm(ux, axis=-1, keepdims=True), 1e-12)
        uy = np.cross(uz, ux)
        uy /= np.maximum(np.linalg.norm(uy, axis=-1, keepdims=True), 1e-12)
        frame = np.stack([ux, uy, uz], axis=-1)         # columns = basis
        quats_all.append(transforms.rotmat_to_quat(
            torch.from_numpy(np.ascontiguousarray(frame))).numpy())
        radius = np.sqrt(np.maximum(vtx_area, 0.0) / np.pi)
        radius = np.clip(radius * scale_init_factor, min_scale + 1e-4,
                         max_scale - 1e-4)
        thickness = np.clip(radius * thickness_init_factor, min_scale + 1e-4,
                            max_scale - 1e-4)
        scales_all.append(np.stack(
            [logit(radius), logit(radius), logit(thickness)],
            axis=-1).astype(np.float32))
    return (np.concatenate(quats_all).astype(np.float32),
            np.concatenate(scales_all))
