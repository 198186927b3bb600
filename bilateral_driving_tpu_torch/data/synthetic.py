"""Synthetic driving scene: port of bilateral_driving_tpu/data/synthetic.py
(`make_scene`, `make_batch`) on torch.Generator, plus scene parameters drawn
straight from the seed (`random_state`; initialising from points, with its
KNN scales, is tools/common.build_synthetic_scene) and `RenderedFrames`,
the image source of the CLI's synthetic mode.

The scene: a camera rig of `num_cams` cameras (yawed like nuScenes' six)
driving forward along +z; a background of ground, two facades and clutter;
rigid "cars" and deformable "pedestrians" with per-frame pose tracks; and,
optionally, SMPL pedestrians walking beside the rig in view of its
cameras, each with its own random body (the licensed SMPL asset is not
used). Cameras follow OpenCV axes (x right, y down, z forward).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import sh as sh_lib
from ..models import bilateral, deform, encoders, sky
from ..scene import pvg, smpl_model
from ..train import setup, trainer
from ..train.trainer import SceneState

CAM_YAWS_DEG = (0.0, 55.0, -55.0, 110.0, -110.0, 180.0)
GROUND_Y = 1.6          # metres below the camera (y points down)
CAR_SIZE = (1.9, 1.6, 4.5)
PED_SIZE = (0.6, 1.8, 0.6)


class SyntheticScene(NamedTuple):
    bg_means: torch.Tensor        # (Nb, 3) world
    bg_colors: torch.Tensor       # (Nb, 3)
    inst: dict                    # class -> local means, colors, point_ids,
    #                               quats (F, I, 4), trans (F, I, 3),
    #                               frame_valid (F, I), sizes (I, 3)
    cam_to_worlds: torch.Tensor   # (F * num_cams, 4, 4), image = f * cams + c
    K: torch.Tensor               # (3, 3)
    width: int
    height: int
    num_frames: int
    num_cams: int


def _u(g, shape, lo, hi):
    return torch.rand(shape, generator=g) * (hi - lo) + lo


def _yaw_quat(yaw):
    zero = torch.zeros_like(yaw)
    return torch.stack([torch.cos(yaw / 2), zero, torch.sin(yaw / 2), zero],
                       dim=-1)


def _instances(g, num, pts, size, num_frames, lanes, speed):
    """Points inside each instance box and a straight pose track per
    instance along z."""
    size_t = torch.tensor(size).expand(num, 3).clone()
    local = (torch.rand((num * pts, 3), generator=g) - 0.5) * size_t[0] * 0.9
    colors = _u(g, (num * pts, 3), 0.1, 0.9)
    point_ids = torch.arange(num, dtype=torch.int32).repeat_interleave(pts)
    lane = torch.tensor(lanes)[torch.randint(len(lanes), (num,),
                                             generator=g)]
    z0 = _u(g, (num,), -10.0, 60.0)
    v = _u(g, (num,), -speed, speed)
    f = torch.arange(num_frames, dtype=torch.float32)[:, None]
    trans = torch.stack([lane.expand(num_frames, num),
                         torch.full((num_frames, num),
                                    GROUND_Y - size[1] / 2),
                         z0 + v * f], dim=-1)
    yaw = torch.where(v >= 0, 0.0, math.pi).expand(num_frames, num)
    frame_valid = torch.rand((num_frames, num), generator=g) > 0.1
    return {"means": local, "colors": colors, "point_ids": point_ids,
            "quats": _yaw_quat(yaw), "trans": trans,
            "frame_valid": frame_valid, "sizes": size_t}


def _smpl_walkers(g, num, num_frames, num_cams):
    """Root yaw quats (F, I, 4), translations (F, I, 3) and frame validity
    (F, I) of SMPL pedestrians: walker i stays 4-10 m from the rig, in the
    view of camera i mod num_cams (within 15 degrees of its axis), its
    body centre 0.9 m above the ground, drifting slowly; about 5% of
    (frame, walker) pairs are invalid."""
    cams = torch.arange(num) % num_cams
    yaw = (torch.tensor([math.radians(CAM_YAWS_DEG[int(c) % 6])
                         for c in cams])
           + math.radians(15.0) * (2 * torch.rand(num, generator=g) - 1))
    dist = _u(g, (num,), 4.0, 10.0)
    drift = _u(g, (num, 3), -0.05, 0.05) * torch.tensor([1.0, 0.0, 1.0])
    f = torch.arange(num_frames, dtype=torch.float32)[:, None, None]
    base = torch.stack([dist * torch.sin(yaw),
                        torch.full((num,), GROUND_Y - 0.9),
                        dist * torch.cos(yaw)], dim=-1)
    rig = torch.stack([torch.zeros(num_frames), torch.zeros(num_frames),
                       torch.arange(num_frames, dtype=torch.float32)], -1)
    trans = rig[:, None, :] + base[None] + drift[None] * f
    heading = _u(g, (num,), -math.pi, math.pi).expand(num_frames, num)
    frame_valid = torch.rand((num_frames, num), generator=g) > 0.05
    return {"quats": _yaw_quat(heading), "trans": trans,
            "frame_valid": frame_valid}


def make_scene(generator: torch.Generator, num_bg: int = 2000,
               num_frames: int = 6, num_cams: int = 1, width: int = 128,
               height: int = 96, focal: float | None = None,
               num_rigid: int = 1, rigid_pts: int = 300,
               num_deformable: int = 0, deformable_pts: int = 0,
               num_smpl: int = 0, device="cuda") -> SyntheticScene:
    g = generator
    n_ground = num_bg * 45 // 100
    n_facade = num_bg * 35 // 100
    n_clutter = num_bg - n_ground - n_facade
    ground = torch.stack([_u(g, (n_ground,), -25, 25),
                          GROUND_Y + _u(g, (n_ground,), -0.02, 0.02),
                          _u(g, (n_ground,), -30, 80)], dim=-1)
    side = torch.where(torch.rand(n_facade, generator=g) < 0.5, -1.0, 1.0)
    facade = torch.stack([side * (10.0 + _u(g, (n_facade,), -0.2, 0.2)),
                          _u(g, (n_facade,), -10, GROUND_Y),
                          _u(g, (n_facade,), -30, 80)], dim=-1)
    clutter = torch.stack([_u(g, (n_clutter,), -25, 25),
                           _u(g, (n_clutter,), -6, GROUND_Y),
                           _u(g, (n_clutter,), -30, 80)], dim=-1)
    bg_means = torch.cat([ground, facade, clutter])
    bg_colors = _u(g, (num_bg, 3), 0.1, 0.9)

    inst = {}
    if num_rigid:
        inst["RigidNodes"] = _instances(g, num_rigid, rigid_pts, CAR_SIZE,
                                        num_frames, (-7.0, -3.5, 3.5, 7.0),
                                        1.5)
    if num_deformable:
        inst["DeformableNodes"] = _instances(
            g, num_deformable, deformable_pts, PED_SIZE, num_frames,
            (-8.5, 8.5), 0.15)

    c2ws = []
    for f in range(num_frames):
        for c in range(num_cams):
            yaw = math.radians(CAM_YAWS_DEG[c % len(CAM_YAWS_DEG)])
            c2w = torch.eye(4)
            c2w[:3, :3] = torch.tensor(
                [[math.cos(yaw), 0.0, math.sin(yaw)], [0.0, 1.0, 0.0],
                 [-math.sin(yaw), 0.0, math.cos(yaw)]])
            c2w[:3, 3] = torch.tensor([0.0, 0.0, 1.0 * f])
            c2ws.append(c2w)
    if num_smpl:
        # drawn last, so a scene without them is drawn as before
        inst["SMPLNodes"] = _smpl_walkers(g, num_smpl, num_frames, num_cams)
    focal = 0.9 * width if focal is None else focal
    K = torch.tensor([[focal, 0.0, width / 2], [0.0, focal, height / 2],
                      [0.0, 0.0, 1.0]])
    to = lambda x: x.to(device)
    inst = {k: {n: to(x) for n, x in v.items()} for k, v in inst.items()}
    return SyntheticScene(to(bg_means), to(bg_colors), inst,
                          to(torch.stack(c2ws)), to(K), width, height,
                          num_frames, num_cams)


def _gaussian_params(g, means, colors, capacity, sh_degree, device):
    """Fixed-capacity Gaussian dict with parameters drawn from `g`; slots
    past the points are dead (mask 0, logit -20, identity quats)."""
    n = means.shape[0]
    k = sh_lib.num_sh_bases(sh_degree)

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill)
        out[:n] = x
        return out.to(device)

    quats = torch.randn((n, 4), generator=g)
    dead_q = torch.zeros((capacity, 4))
    dead_q[:, 0] = 1.0
    dead_q[:n] = quats / quats.norm(dim=-1, keepdim=True)
    params = {
        "means": pad(means.cpu()),
        "log_scales": pad(torch.log(_u(g, (n, 3), 0.04, 0.2))),
        "quats": dead_q.to(device),
        "logit_opacities": pad(_u(g, (n, 1), -2.0, 3.0), -20.0),
        "sh_dc": pad(sh_lib.rgb_to_sh(colors.cpu())[:, None, :]),
        "sh_rest": pad(torch.randn((n, k - 1, 3), generator=g) * 0.05),
    }
    mask = torch.zeros(capacity)
    mask[:n] = 1.0
    return params, mask.to(device)


def _smpl_state(g, d, cfg, smpl_verts: int, device):
    """SMPLNodes of the scene's walkers through train.setup.build_smpl:
    one synthetic body of `smpl_verts` vertices, random betas, the
    da-pose with per-frame joint perturbations, and anisotropic scales of
    0.5-3 cm drawn here (build_smpl's isotropic 1 cm leave the
    quaternions without gradient)."""
    num_frames, num = d["trans"].shape[:2]
    model = smpl_model.synthetic_model(g, num_verts=smpl_verts,
                                       device=device)
    betas = torch.randn((num, 10), generator=g)
    body = (smpl_model.da_pose_quats(device="cpu")[1:]
            + 0.1 * torch.randn((num_frames, num, 23, 4), generator=g))
    out = setup.build_smpl(
        g, model, betas.to(device), d["quats"][:, :, None, :],
        body.to(device), d["trans"], d["frame_valid"],
        sh_degree=cfg.sh_degree, use_voxel_deformer=cfg.use_voxel_deformer)
    n = out[0]["log_scales"].shape[0]
    out[0]["log_scales"] = torch.log(_u(g, (n, 3), 0.005, 0.03)).to(device)
    if cfg.use_voxel_deformer:
        corr = out[0]["voxel_w_correction"]
        corr += 0.01 * torch.randn(corr.shape, generator=g).to(device)
    return out


def random_state(scene: SyntheticScene, cfg, generator: torch.Generator,
                 bg_capacity: int, step: int, device="cuda",
                 smpl_verts: int = 6890):
    """Scene parameters of every class of `cfg` drawn from `generator`: the
    Background of cfg.background_model (PVG's taus over the scaled time
    axis, life spans and velocities, or DeformableGS's network and
    contraction box), the rigid and deformable instances cfg turns on, the
    sky of cfg.sky_model (an EnvLight texture of two scales of noise, or
    the MLP sky's init; none for "none"), the
    appearance model cfg.affine_model names (grids near the identity, the
    other models' arrays moved off their zero or random init), the camera
    refinements cfg asks for (pose embeddings near zero), and with
    cfg.use_smpl SMPLNodes of the scene's walkers (bodies of
    `smpl_verts` vertices, the SMPL mesh's count by default), drawn last,
    their voxel deformer's correction (cfg.use_voxel_deformer) moved off
    zero by 0.01 N(0, 1). Returns (SceneState, statics)."""
    g = generator
    params, statics, aux, masks = {}, {}, {}, {}
    params["Background"], masks["Background"] = _gaussian_params(
        g, scene.bg_means, scene.bg_colors, bg_capacity, cfg.sh_degree,
        device)
    bg, n_bg = params["Background"], scene.bg_means.shape[0]
    if cfg.background_model == "pvg":
        ts = cfg.pvg_time_interval * max(scene.num_frames - 1, 1)
        bg.update(pvg.init_extras(bg_capacity, n_bg, _u(g, (n_bg,), 0.0, ts),
                                  device=device))
        bg["log_betas"] += 0.1 * torch.randn((bg_capacity,),
                                             generator=g).to(device)
        bg["velocity"] += 0.3 * torch.randn((bg_capacity, 3),
                                            generator=g).to(device)
    elif cfg.background_model == "deformgs":
        bg["deform_net"] = deform.DeformNetwork().reset_parameters(g).to(
            device).requires_grad_(False)
        lo, hi = scene.bg_means.amin(0), scene.bg_means.amax(0)
        statics["Background"] = {"aabb_center": 0.5 * (lo + hi),
                                 "aabb_scale": 0.5 * (hi - lo).max()}
    enabled = {"RigidNodes": cfg.use_rigid,
               "DeformableNodes": cfg.use_deformable}
    for name, d in scene.inst.items():
        if name == "SMPLNodes" or not enabled.get(name, False):
            continue
        p, masks[name] = _gaussian_params(g, d["means"], d["colors"],
                                          d["means"].shape[0], cfg.sh_degree,
                                          device)
        p["instances_quats"] = d["quats"]
        p["instances_trans"] = d["trans"]
        if name == "DeformableNodes":
            num_inst = d["sizes"].shape[0]
            p["instance_embeds"] = encoders.embedding_init(num_inst, 16, g,
                                                           device)
            p["deform_net"] = deform.DeformNetwork(
                embed_dim=16).reset_parameters(g).to(device).requires_grad_(
                    False)
        params[name] = p
        statics[name] = {"instances_fv": d["frame_valid"],
                         "instances_size": d["sizes"]}
        aux[name] = {"point_ids": d["point_ids"]}
    if cfg.sky_model == "envlight":
        res = cfg.envlight_resolution
        base = (0.4 + 0.4 * torch.rand((6, 1, 1, 3), generator=g)
                + 0.05 * torch.rand((6, res, res, 3), generator=g))
        params["Sky"] = {"base": base.to(device)}
    elif cfg.sky_model == "mlp":
        params["Sky"] = sky.init_sky_mlp(cfg.num_images, g, device=device)
    if cfg.affine_model == "bilateral":
        affine = bilateral.init_bilateral(
            cfg.num_images, *cfg.bilateral_grid_shape, device=device)
        arrays = [affine["grids"]]
    elif cfg.affine_model == "multiscale_bilateral":
        affine = bilateral.init_multiscale(cfg.num_images, cfg.ms_grid,
                                           device)
        arrays = [level["grids"] for level in affine["levels"]]
    else:
        # the other appearance models and the camera refinements, every
        # array moved off its initial value (zero codes, decoders, heads,
        # feature grids and pose embeddings give no gradient to some leaves)
        models = setup.appearance_models(cfg, device, g)
        affine = models.pop("Affine", None)       # none: no appearance
        arrays = [p for _, p in trainer.named_leaves(affine or {})]
        for name, model in models.items():
            model["embeds"] += 1e-3 * torch.randn(
                model["embeds"].shape, generator=g).to(device)
            params[name] = model
    for x in arrays:
        x += 0.02 * torch.randn(x.shape, generator=g).to(device)
    if affine is not None:
        params["Affine"] = affine
    if cfg.use_smpl:
        (params["SMPLNodes"], statics["SMPLNodes"], aux["SMPLNodes"],
         masks["SMPLNodes"]) = _smpl_state(g, scene.inst["SMPLNodes"], cfg,
                                           smpl_verts, device)
    return SceneState(params, aux, masks, step), statics


def pixel_viewdirs(h: int, w: int, K: torch.Tensor, c2w: torch.Tensor):
    """(h, w, 3) unit world view directions through pixel centres."""
    xs = (torch.arange(w, device=K.device) + 0.5 - K[0, 2]) / K[0, 0]
    ys = (torch.arange(h, device=K.device) + 0.5 - K[1, 2]) / K[1, 1]
    d_cam = torch.stack(torch.broadcast_tensors(
        xs[None, :], ys[:, None], torch.ones((1, 1), device=K.device)),
        dim=-1)
    d_world = d_cam @ c2w[:3, :3].T
    return d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)


def make_batch(scene: SyntheticScene, image_idx: int, pixels=None,
               sky_mask=None, depth_map=None):
    """Trainer batch for one image, with `pixels` as its target, `sky_mask`
    (H, W) its sky pixels and `depth_map` (H, W) its lidar depths, 0 where
    there is no return (all zeros by default)."""
    h, w = scene.height, scene.width
    c2w = scene.cam_to_worlds[image_idx]
    frame = image_idx // scene.num_cams
    zeros = lambda *shape: torch.zeros(shape, device=c2w.device)
    return {
        "pixels": zeros(h, w, 3) if pixels is None else pixels,
        "sky_masks": zeros(h, w) if sky_mask is None else sky_mask,
        "lidar_depth_map": zeros(h, w) if depth_map is None else depth_map,
        "viewdirs": pixel_viewdirs(h, w, scene.K, c2w),
        "img_idx": image_idx,
        "frame_idx": frame,
        "normed_time": frame / max(scene.num_frames - 1, 1),
        "camera_to_world": c2w,
        "intrinsics": scene.K,
    }


class SyntheticData:
    """Image source over a SyntheticScene for eval.render_loop."""

    def __init__(self, scene: SyntheticScene):
        self.scene = scene
        self.num_images = scene.num_frames * scene.num_cams

    def get_batch(self, image_idx: int, downscale: int = 1):
        if downscale != 1:
            raise ValueError("a synthetic scene renders at its own size")
        return make_batch(self.scene, image_idx)

    def neighbor_train_indices(self, test_stride: int, k: int = 2):
        """test image -> the k nearest training images of the same camera
        (frames test_stride, 2 test_stride, ... are test frames)."""
        cams = self.scene.num_cams
        frames = range(self.scene.num_frames)
        train = [f for f in frames if f == 0 or f % test_stride]
        out = {}
        for f in frames:
            if f in train:
                continue
            near = sorted(train, key=lambda t: abs(t - f))[:k]
            for c in range(cams):
                out[f * cams + c] = [t * cams + c for t in near]
        return out


class RenderedFrames:
    """The frames of a one-camera SyntheticScene with given target images:
    the image source of the training CLI's synthetic mode (its rendered
    ground truth) and of eval.render_loop. Every frame trains; there are
    no sky, object or lidar maps (all zero) and no test split."""

    def __init__(self, scene: SyntheticScene, pixels):
        self.scene = scene
        self.num_images = len(pixels)
        self.batches = [make_batch(scene, i, p) for i, p in enumerate(pixels)]
        zeros = np.zeros((self.num_images, scene.height, scene.width),
                         np.float32)
        self.sky_masks = self.dynamic_masks = zeros
        self.human_masks = self.vehicle_masks = zeros
        self.lidar_depth_maps = None

    def get_batch(self, image_idx: int, downscale: int = 1):
        if downscale != 1:
            raise ValueError("synthetic frames train at their own size")
        return self.batches[image_idx]

    def split_train_test(self, test_stride: int):
        return np.arange(self.num_images), np.zeros(0, np.int64)

    def neighbor_train_indices(self, test_stride: int, k: int = 2):
        return {}
