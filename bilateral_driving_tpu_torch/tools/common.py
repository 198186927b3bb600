"""Configuration tree -> trainer construction shared by the CLIs: port of
bilateral_driving_tpu/tools/common.py for real drivestudio scene
directories and the ported classes.

`trainer_config_from` maps a tree (configs.PRESETS plus overrides) onto
TrainerConfig; `build_real_scene` loads a scene and builds every class
from its points. SMPL-class instances become SMPLNodes when
`trainer.use_smpl` is on and a body model is given (`smpl.model_path`: the
SMPL pickle, or "synthetic" for the port's own random body); otherwise they
go to DeformableNodes, as in the JAX package. The Background is vanilla,
PVG or DeformableGS (`trainer.background_model`).
`build_synthetic_scene` builds the generated scene of `data.synthetic`
(configs/synthetic.yaml) through the same builders.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core import transforms
from ..data import scene as scene_mod, synthetic
from ..scene import smpl_model
from ..train import density, setup, trainer
from ..utils.config import ConfigDict, validate_keys


def _leaves(*names):
    return {n: True for n in names}


# every key a CLI or builder consumes (the JAX package's schema, plus
# data.pixel_pack); validate_config rejects the rest, so a misspelled
# override fails instead of training with a default
CONFIG_SCHEMA = {
    "seed": True,
    "dataset": True,
    "trainer": _leaves(
        "background_model", "use_rigid", "use_smpl", "use_deformable",
        "sky_model", "affine_model", "use_camera_opt", "use_camera_perturb",
        "use_voxel_deformer", "sh_degree", "sh_degree_interval",
        "envlight_resolution", "max_steps", "ms_grid", "guidance_factor",
        "bilateral_grid_shape", "steps_per_dispatch"),
    "render": _leaves("near_plane", "far_plane", "radius_clip", "antialiased",
                      "isect_capacity", "capacity_policy", "capacity_margin",
                      "capacity_floor", "rebucket_after"),
    "losses": {
        **_leaves(
            "rgb", "ssim", "mask", "mask_loss_type", "depth",
            "depth_loss_type", "depth_inverse", "depth_normalize",
            "depth_reduction", "max_depth", "lidar_w_decay", "affine",
            "affine_inverse", "opacity_entropy", "inverse_depth_smoothness",
            "rigid_temporal", "smpl_joint_smooth"),
        "dynamic_region": _leaves("w", "start_from"),
    },
    "background_reg": {"*": {"*": True}},
    "smpl_reg": {"*": {"*": True}},
    "density": {f: True for f in density.DensityConfig._fields},
    "background_init": _leaves("num_lidar_samples", "num_near_pts",
                               "num_far_pts", "capacity"),
    "rigid_capacity": True,
    "deformable_capacity": True,
    "sampler": _leaves("buffer_ratio", "start_enhance_weight",
                       "refresh_every", "refresh_downscale"),
    "data": _leaves(
        "dataset", "scene_dir", "cameras", "downscale", "test_image_stride",
        "num_cams", "start_frame", "end_frame", "undistort", "ego_mask_dir",
        "synthetic", "width", "height", "num_frames", "num_bg",
        "bg_capacity", "pixel_pack"),
    "pvg": _leaves("cycle_length", "time_interval", "betas_init",
                   "enable_temporal_smoothing", "smooth_probability",
                   "distribution_span"),
    "smpl": _leaves("model_path"),
    "logging": _leaves("log_every", "ckpt_every", "vis_freq",
                       "metrics_flush_every"),
    "res_schedule": _leaves("double_steps", "downscale_times"),
    "optim": {"*": _leaves("lr", "lr_final", "warmup_steps")},
}


def validate_config(cfg: ConfigDict):
    unknown = validate_keys(cfg, CONFIG_SCHEMA)
    if unknown:
        raise ValueError(
            "unknown config keys (misspelled override?): "
            + ", ".join(sorted(unknown)))


def trainer_config_from(cfg: ConfigDict, num_images: int, num_frames: int,
                        scene_scale: float,
                        scene_origin=(0.0, 0.0, 0.0)) -> trainer.TrainerConfig:
    """The JAX package's mapping, with its defaults for absent keys, onto
    the fields the port's TrainerConfig has."""
    validate_config(cfg)
    t = cfg.get("trainer", {})
    losses = cfg.get("losses", {})
    dens = cfg.get("density", {})
    render = cfg.get("render", {})
    pvg = cfg.get("pvg", {})
    den = density.DensityConfig(**{k: v for k, v in dens.items()
                                   if k in density.DensityConfig._fields})
    kw = dict(
        background_model=t.get("background_model", "vanilla"),
        use_rigid=t.get("use_rigid", False),
        use_smpl=t.get("use_smpl", False),
        use_deformable=t.get("use_deformable", False),
        sky_model=t.get("sky_model", "envlight"),
        affine_model=t.get("affine_model", "multiscale_bilateral"),
        use_camera_opt=t.get("use_camera_opt", False),
        use_camera_perturb=t.get("use_camera_perturb", False),
        use_voxel_deformer=t.get("use_voxel_deformer", False),
        near_plane=render.get("near_plane", 0.1),
        far_plane=render.get("far_plane", 1e7),
        radius_clip=render.get("radius_clip", 0.0),
        antialiased=render.get("antialiased", False),
        isect_capacity=int(render.get("isect_capacity", 2 ** 20)),
        sh_degree=t.get("sh_degree", 3),
        sh_degree_interval=t.get("sh_degree_interval", 1000),
        envlight_resolution=t.get("envlight_resolution", 512),
        num_images=num_images,
        num_frames=num_frames,
        w_rgb=losses.get("rgb", 0.8),
        w_ssim=losses.get("ssim", 0.2),
        w_mask=losses.get("mask", 0.05),
        w_depth=losses.get("depth", 0.01),
        lidar_w_decay=losses.get("lidar_w_decay", -1.0),
        w_affine=losses.get("affine", 1e-5),
        w_affine_inverse=losses.get("affine_inverse", 0.0),
        w_opacity_entropy=losses.get("opacity_entropy", 0.0),
        w_inverse_depth_smoothness=losses.get("inverse_depth_smoothness", 0.0),
        depth_loss_type=losses.get("depth_loss_type", "l1"),
        depth_inverse=losses.get("depth_inverse", False),
        depth_normalize=losses.get("depth_normalize", False),
        depth_reduction=losses.get("depth_reduction", "mean_on_hit"),
        mask_loss_type=losses.get("mask_loss_type", "safe_bce"),
        max_depth=losses.get("max_depth", 80.0),
        pvg_cycle=pvg.get("cycle_length", 0.2),
        pvg_time_interval=pvg.get("time_interval", 0.02),
        pvg_temporal_smoothing=pvg.get("enable_temporal_smoothing", False),
        pvg_smooth_probability=pvg.get("smooth_probability", 0.5),
        pvg_distribution_span=pvg.get("distribution_span", 1.5),
        w_rigid_temporal=losses.get("rigid_temporal", 0.0),
        w_smpl_joint_smooth=losses.get("smpl_joint_smooth", 0.0),
        # presence of the dynamic_region block enables it at the reference's
        # default weight 1.0 (base.py:640-641)
        w_dynamic_region=(losses.get("dynamic_region") or {}).get("w", 1.0)
        if losses.get("dynamic_region") is not None else 0.0,
        dynamic_region_start_from=int(
            (losses.get("dynamic_region") or {}).get("start_from", 0)),
        density=den,
        scene_scale=scene_scale,
        scene_origin=tuple(float(x) for x in scene_origin),
        max_steps=t.get("max_steps", 30000),
    )
    if "ms_grid" in t:
        kw["ms_grid"] = tuple(tuple(g) for g in t["ms_grid"])
    if "guidance_factor" in t:
        kw["guidance_factor"] = tuple(t["guidance_factor"])
    if "bilateral_grid_shape" in t:
        kw["bilateral_grid_shape"] = tuple(t["bilateral_grid_shape"])
    for key in ("background_reg", "smpl_reg"):
        regs = cfg.get(key, None)
        if regs:
            kw[key] = tuple((k, tuple(v.items())) for k, v in regs.items())
    optim = cfg.get("optim", None)
    if optim:
        # per-config lr-group overrides: group -> {lr, lr_final,
        # warmup_steps}
        default_lr = next(f for f in dataclasses.fields(trainer.TrainerConfig)
                          if f.name == "lr").default
        table = {e[0]: list(e[1:]) for e in default_lr}
        for group, ov in optim.items():
            base = table.get(group, [1e-3, None, 0])
            table[group] = [ov.get("lr", base[0]),
                            ov.get("lr_final", base[1]),
                            ov.get("warmup_steps", base[2])]
        kw["lr"] = tuple((k, *v) for k, v in table.items())
    return trainer.TrainerConfig(**kw)


def _background_from_scene(generator, cfg, data: scene_mod.SceneData,
                           tcfg, device):
    """The Background of any background_model (vanilla | pvg | deformgs)
    from the scene's lidar and sphere points. Returns (params, mask,
    statics)."""
    init = cfg.get("background_init", {})
    pts, pt_times = scene_mod.get_init_background(
        data, num_samples=init.get("num_lidar_samples", 400_000),
        num_near=init.get("num_near_pts", 50_000),
        num_far=init.get("num_far_pts", 50_000), return_times=True)
    colors = scene_mod.lidar_colors_for_points(data, pts)
    capacity = int(init.get("capacity", max(2 ** 19, 2 * pts.shape[0])))
    capacity = max(capacity, pts.shape[0])
    pts = torch.from_numpy(pts).to(device)
    colors = torch.from_numpy(colors).to(device)
    if tcfg.background_model == "pvg":
        params, mask = setup.build_pvg_background(
            generator, capacity, pts, colors,
            t_init=torch.from_numpy(pt_times), sh_degree=tcfg.sh_degree,
            beta_init=cfg.get("pvg", {}).get("betas_init", 0.1),
            time_scale=tcfg.pvg_time_interval * max(tcfg.num_frames - 1, 1))
        return params, mask, {}
    if tcfg.background_model == "deformgs":
        aabb = data.aabb()
        params, statics, mask = setup.build_deformgs_background(
            generator, capacity, pts, colors, 0.5 * (aabb[0] + aabb[1]),
            float(np.max(aabb[1] - aabb[0]) / 2.0),
            sh_degree=tcfg.sh_degree)
        return params, mask, statics
    if tcfg.background_model != "vanilla":
        raise ValueError(
            f"unknown background_model {tcfg.background_model!r}")
    params, mask = setup.build_background(generator, capacity, pts, colors,
                                          sh_degree=tcfg.sh_degree)
    return params, mask, {}


def build_real_scene(cfg: ConfigDict, seed: int = 0, device="cuda"):
    """Load the drivestudio scene of cfg.data and construct every class.
    Random draws come from a CPU torch.Generator seeded with `seed`, so a
    scene builds alike on every device. Returns (tcfg, data, params,
    statics, aux, masks)."""
    d = cfg.data
    data = scene_mod.load_scene(
        d.scene_dir, cameras=tuple(d.get("cameras", (0,))),
        start_frame=d.get("start_frame", 0), end_frame=d.get("end_frame", -1),
        downscale=d.get("downscale", 1.0), dataset=d.get("dataset", None),
        undistort=d.get("undistort", False),
        ego_mask_dir=d.get("ego_mask_dir", None),
        pixel_pack=d.get("pixel_pack", None), device=device)
    aabb = data.aabb()
    tcfg = trainer_config_from(cfg, data.num_images, data.num_frames,
                               data.scene_radius(),
                               scene_origin=0.5 * (aabb[0] + aabb[1]))
    gen = torch.Generator().manual_seed(seed)
    # the appearance and camera models draw from a generator of their own,
    # so the Gaussians' draws are the same for every appearance model
    params = setup.build_models(tcfg, device,
                                torch.Generator().manual_seed(seed + 1))
    masks, aux, statics = {}, {}, {}

    bg, masks["Background"], statics["Background"] = _background_from_scene(
        gen, cfg, data, tcfg, device)
    params["Background"] = bg
    aux["Background"] = {}

    def tensors(obj):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return (t(obj["means"]),
                t(scene_mod.lidar_colors_for_points(data, obj["means"])),
                t(obj["point_ids"]), t(obj["quats"]), t(obj["trans"]),
                t(obj["frame_valid"]), t(obj["sizes"]))

    if tcfg.use_rigid:
        obj = scene_mod.get_init_objects(data, "RigidNodes")
        if obj is not None:
            cap = int(cfg.get("rigid_capacity", 2 * obj["means"].shape[0]))
            (params["RigidNodes"], statics["RigidNodes"], aux["RigidNodes"],
             masks["RigidNodes"]) = setup.build_rigid(
                gen, cap, *tensors(obj), sh_degree=tcfg.sh_degree)
        else:
            # safe_init_models: drop empty classes (scene_graph.py:73-84)
            tcfg = dataclasses.replace(tcfg, use_rigid=False)

    if tcfg.use_smpl:
        built = _smpl_from_scene(gen, cfg, data, tcfg, device)
        if built is not None:
            (params["SMPLNodes"], statics["SMPLNodes"], aux["SMPLNodes"],
             masks["SMPLNodes"]) = built
        else:
            tcfg = dataclasses.replace(tcfg, use_smpl=False)

    if tcfg.use_deformable:
        # with SMPL off (or no body model) SMPL-class instances fall
        # through to DeformableNodes (the reference's load_smpl=False
        # routing)
        obj = scene_mod.get_init_objects(
            data, ("DeformableNodes",) if tcfg.use_smpl
            else ("DeformableNodes", "SMPLNodes"))
        if obj is not None:
            cap = int(cfg.get("deformable_capacity",
                              2 * obj["means"].shape[0]))
            (params["DeformableNodes"], statics["DeformableNodes"],
             aux["DeformableNodes"], masks["DeformableNodes"]) = \
                setup.build_deformable(gen, cap, *tensors(obj),
                                       obj["sizes"].shape[0],
                                       sh_degree=tcfg.sh_degree)
        else:
            tcfg = dataclasses.replace(tcfg, use_deformable=False)

    return tcfg, data, params, statics, aux, masks


def _smpl_from_scene(generator, cfg, data, tcfg, device):
    """SMPLNodes from the scene's SMPL-class instances and their tracked
    poses (data.smpl_poses): the body is the pickle at smpl.model_path,
    or with "synthetic" the port's own random body of 256 vertices (drawn
    from a fixed seed, so every build has the same body). None without
    instances, without a body model or without SMPL-class instances."""
    smpl_path = cfg.get_path("smpl.model_path")
    inst = data.instances
    synthetic_body = smpl_path == "synthetic"
    if inst is None or smpl_path is None or not (
            synthetic_body or os.path.exists(smpl_path)):
        return None
    sel = [i for i, nt in enumerate(inst.node_types) if nt == "SMPLNodes"]
    if not sel:
        return None
    model = (smpl_model.synthetic_model(torch.Generator().manual_seed(0),
                                        num_verts=256, device=device)
             if synthetic_body else smpl_model.load_model(smpl_path, device))
    F, I = data.num_frames, len(sel)
    poses = inst.poses[:, sel]
    root_q = transforms.rotmat_to_quat(
        torch.from_numpy(np.ascontiguousarray(poses[..., :3, :3]))).numpy()
    body = np.broadcast_to(
        smpl_model.da_pose_quats(device="cpu")[1:].numpy(),
        (F, I, 23, 4)).copy()
    betas = np.zeros((I, 10), np.float32)
    frame_valid = inst.frame_valid[:, sel].copy()
    # tracked joint angles: root = the world-rotated global orient, body =
    # the 23 joint quats; the translation stays the instance box centre
    if data.smpl_poses:
        for local_i, i in enumerate(sel):
            track = data.smpl_poses.get(str(inst.ids[i]))
            if track is None:
                continue
            tv = track["valid"]
            root_q[tv, local_i] = track["quats"][tv, 0]
            body[tv, local_i] = track["quats"][tv, 1:]
            betas[local_i] = track["betas"]
            frame_valid[:, local_i] &= tv
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return setup.build_smpl(
        generator, model, t(betas), t(root_q)[:, :, None, :], t(body),
        t(poses[..., :3, 3]), t(frame_valid), sh_degree=tcfg.sh_degree,
        use_voxel_deformer=tcfg.use_voxel_deformer)


def build_synthetic_scene(cfg: ConfigDict, seed: int = 0, device="cuda",
                          scene: synthetic.SyntheticScene | None = None,
                          smpl_body: smpl_model.SMPLModel | None = None):
    """The generated scene of `data.synthetic` (the JAX package's
    tools/common.build_synthetic_scene): data/synthetic.make_scene's
    background and rigid car under one camera, `data.bg_capacity`
    background slots (vanilla, PVG or DeformableGS), RigidNodes of capacity
    1,024, with trainer.use_smpl one SMPL pedestrian of a synthetic body of
    64 vertices in the DA pose at (0, 0, 8), and with
    trainer.use_deformable DeformableNodes on the rigid instances. The
    scene is drawn from a CPU generator seeded `seed`, which then draws the
    background and rigid Gaussians; the appearance model, SMPLNodes and
    DeformableNodes draw from generators seeded seed + 1, + 2 and + 3.
    `scene` and `smpl_body` replace the drawn scene and body (tests carry
    the JAX package's over). Returns (tcfg, scene, params, statics, aux,
    masks)."""
    d = cfg.get("data", {})
    num_frames = d.get("num_frames", 6)
    gen = torch.Generator().manual_seed(seed)
    if scene is None:
        scene = synthetic.make_scene(
            gen, num_bg=d.get("num_bg", 3000), num_frames=num_frames,
            width=d.get("width", 128), height=d.get("height", 96),
            device=device)
    tcfg = trainer_config_from(cfg, scene.num_frames, scene.num_frames, 15.0)
    params = setup.build_models(tcfg, device,
                                torch.Generator().manual_seed(seed + 1))
    masks, aux, statics = {}, {}, {"Background": {}}
    bg_cap = d.get("bg_capacity", 8192)
    if tcfg.background_model == "pvg":
        bg, masks["Background"] = setup.build_pvg_background(
            gen, bg_cap, scene.bg_means, scene.bg_colors,
            sh_degree=tcfg.sh_degree,
            time_scale=tcfg.pvg_time_interval * max(tcfg.num_frames - 1, 1))
    elif tcfg.background_model == "deformgs":
        bg, statics["Background"], masks["Background"] = \
            setup.build_deformgs_background(
                gen, bg_cap, scene.bg_means, scene.bg_colors,
                torch.zeros(3, device=device), 20.0,
                sh_degree=tcfg.sh_degree)
    elif tcfg.background_model == "vanilla":
        bg, masks["Background"] = setup.build_background(
            gen, bg_cap, scene.bg_means, scene.bg_colors,
            sh_degree=tcfg.sh_degree)
    else:
        raise ValueError(
            f"unknown background_model {tcfg.background_model!r}")
    params["Background"] = bg
    aux["Background"] = {}
    car = scene.inst["RigidNodes"]
    car_args = (car["means"], car["colors"], car["point_ids"], car["quats"],
                car["trans"], car["frame_valid"], car["sizes"])
    if tcfg.use_rigid:
        (params["RigidNodes"], statics["RigidNodes"], aux["RigidNodes"],
         masks["RigidNodes"]) = setup.build_rigid(
            gen, 1024, *car_args, sh_degree=tcfg.sh_degree)
    if tcfg.use_smpl:
        smpl_gen = torch.Generator().manual_seed(seed + 2)
        body = smpl_body if smpl_body is not None else \
            smpl_model.synthetic_model(smpl_gen, num_verts=64, device=device)
        F, I = scene.num_frames, 1
        da = smpl_model.da_pose_quats(device=device)
        trans = torch.tensor([0.0, 0.0, 8.0], device=device)
        (params["SMPLNodes"], statics["SMPLNodes"], aux["SMPLNodes"],
         masks["SMPLNodes"]) = setup.build_smpl(
            smpl_gen, body, torch.zeros((I, 10), device=device),
            da[0].expand(F, I, 1, 4).clone(),
            da[1:].expand(F, I, 23, 4).clone(),
            trans.expand(F, I, 3).clone(),
            torch.ones((F, I), dtype=torch.bool, device=device),
            sh_degree=tcfg.sh_degree,
            use_voxel_deformer=tcfg.use_voxel_deformer)
    if tcfg.use_deformable:
        # the synthetic scene reuses its rigid instances as deformable ones
        (params["DeformableNodes"], statics["DeformableNodes"],
         aux["DeformableNodes"], masks["DeformableNodes"]) = \
            setup.build_deformable(
                torch.Generator().manual_seed(seed + 3), 1024, *car_args,
                car["sizes"].shape[0], sh_degree=tcfg.sh_degree)
    return tcfg, scene, params, statics, aux, masks
