"""Synthetic driving scene: port of bilateral_driving_tpu/data/synthetic.py
(`make_scene`, `make_batch`) on torch.Generator, plus scene parameters drawn
straight from the seed (initialising from points, with its KNN scales, is
training set-up and waits for the training slice).

The scene: a camera rig of `num_cams` cameras (yawed like nuScenes' six)
driving forward along +z; a background of ground, two facades and clutter;
rigid "cars" and deformable "pedestrians" with per-frame pose tracks.
Cameras follow OpenCV axes (x right, y down, z forward).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import sh as sh_lib
from ..models import bilateral, deform, encoders
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


def make_scene(generator: torch.Generator, num_bg: int = 2000,
               num_frames: int = 6, num_cams: int = 1, width: int = 128,
               height: int = 96, focal: float | None = None,
               num_rigid: int = 1, rigid_pts: int = 300,
               num_deformable: int = 0, deformable_pts: int = 0,
               device="cuda") -> SyntheticScene:
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


def random_state(scene: SyntheticScene, cfg, generator: torch.Generator,
                 bg_capacity: int, step: int, device="cuda"):
    """Scene parameters of every flagship class drawn from `generator`.
    Returns (SceneState, statics)."""
    g = generator
    params, statics, aux, masks = {}, {}, {}, {}
    params["Background"], masks["Background"] = _gaussian_params(
        g, scene.bg_means, scene.bg_colors, bg_capacity, cfg.sh_degree,
        device)
    for name, d in scene.inst.items():
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
                embed_dim=16).reset_parameters(g).to(device)
        params[name] = p
        statics[name] = {"instances_fv": d["frame_valid"],
                         "instances_size": d["sizes"]}
        aux[name] = {"point_ids": d["point_ids"]}
    res = cfg.envlight_resolution
    base = (0.4 + 0.4 * torch.rand((6, 1, 1, 3), generator=g)
            + 0.05 * torch.rand((6, res, res, 3), generator=g))
    params["Sky"] = {"base": base.to(device)}
    affine = bilateral.init_multiscale(cfg.num_images, cfg.ms_grid, device)
    for level in affine["levels"]:
        level["grids"] += 0.02 * torch.randn(
            level["grids"].shape, generator=g).to(device)
    params["Affine"] = affine
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


def make_batch(scene: SyntheticScene, image_idx: int, pixels=None):
    """Trainer batch for one image, with `pixels` as its target (zeros by
    default)."""
    h, w = scene.height, scene.width
    c2w = scene.cam_to_worlds[image_idx]
    frame = image_idx // scene.num_cams
    if pixels is None:
        pixels = torch.zeros((h, w, 3), device=c2w.device)
    return {
        "pixels": pixels,
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

    def get_batch(self, image_idx: int):
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
