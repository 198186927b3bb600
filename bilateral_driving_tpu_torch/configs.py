"""The ported configurations as Python presets.

The JAX package reads `bilateral_driving_tpu/configs/*.yaml` through
PyYAML; the port carries the same trees here, every block of them:
FLAGSHIP_TREE is omnire_ms_bilateral.yaml, each other preset a variant of
it named after its YAML (PRESETS), and DATASET_PRESETS holds the 19
dataset rigs of configs/datasets/<dataset>/<n>cams.yaml under
"<dataset>/<n>cams". The CLI (tools/train.py) starts from a preset of
PRESETS or a YAML file (utils/config.load_yaml), merges a rig and applies
`key=value` overrides; tools.common.trainer_config_from maps a tree onto
TrainerConfig. tests/test_torch_configs.py holds every preset equal to
PyYAML's load of its YAML and to what the JAX package builds from it,
tests/test_torch_yaml.py every rig.
"""
from __future__ import annotations

import copy
import dataclasses

from .train.trainer import TrainerConfig

FLAGSHIP_TREE = {
    "trainer": {
        "background_model": "vanilla",
        "use_rigid": True,
        "use_smpl": False,
        "use_deformable": True,
        "sky_model": "envlight",
        "affine_model": "multiscale_bilateral",
        "use_camera_opt": False,
        "sh_degree": 3,
        "sh_degree_interval": 1000,
        "envlight_resolution": 1024,
        "max_steps": 30000,
    },
    "render": {
        "near_plane": 0.1,
        "far_plane": 10000000000.0,
        "radius_clip": 0.0,
        "antialiased": False,
        "isect_capacity": 2097152,
    },
    "losses": {
        "rgb": 0.8,
        "ssim": 0.2,
        "mask": 0.05,
        "depth": 0.01,
        "lidar_w_decay": -1,
        "depth_loss_type": "l1",
        "max_depth": 80.0,
        "affine": 0.01,
        "affine_inverse": 0.0,
        "opacity_entropy": 0.0,
        "inverse_depth_smoothness": 0.0,
        "rigid_temporal": 0.0,
        "smpl_joint_smooth": 0.01,
    },
    "background_reg": {
        "sharp_shape_reg": {"w": 1.0, "max_gauss_ratio": 10.0,
                            "step_interval": 10},
    },
    "density": {
        "densify_grad_thresh": 0.0005,
        "densify_size_thresh": 0.003,
        "n_split_samples": 2,
        "cull_alpha_thresh": 0.005,
        "cull_scale_thresh": 0.5,
        "reset_alpha_interval": 3000,
        "reset_alpha_value": 0.01,
        "refine_interval": 100,
        "warmup_steps": 500,
        "stop_split_at": 15000,
        "stop_screen_size_at": 4000,
    },
    "background_init": {
        "num_lidar_samples": 800000,
        "num_near_pts": 100000,
        "num_far_pts": 100000,
        "capacity": 2097152,
    },
    "sampler": {
        "buffer_ratio": 0.5,
        "start_enhance_weight": 3,
        "refresh_every": 4000,
        "refresh_downscale": 4,
    },
    "data": {
        "scene_dir": None,
        "cameras": [0, 1, 2, 3, 4, 5],
        "start_frame": 0,
        "end_frame": -1,
        "downscale": 3,
        "test_image_stride": 10,
        "num_cams": 6,
    },
    "smpl": {"model_path": None},
    "logging": {"log_every": 100, "ckpt_every": 10000, "vis_freq": 2000},
    "res_schedule": {"double_steps": 250, "downscale_times": 2},
}


def _variant(base: dict, changes: dict, drop=()) -> dict:
    """A copy of `base` with `changes` merged block by block and the
    dotted keys (or whole blocks) of `drop` removed."""
    tree = copy.deepcopy(base)
    for block, value in changes.items():
        if isinstance(value, dict) and isinstance(tree.get(block), dict):
            tree[block].update(value)
        else:
            tree[block] = copy.deepcopy(value)
    for path in drop:
        block, _, key = path.partition(".")
        if key:
            del tree[block][key]
        else:
            del tree[block]
    return tree


# omnire_bilateral.yaml: the flagship tree with SMPLNodes on, the single
# grid, its TV weight 10 and affine lr 1e-5 (no schedule); the YAML has no
# sampler refresh and no vis_freq
OMNIRE_BILATERAL_TREE = _variant(
    FLAGSHIP_TREE,
    {"trainer": {"use_smpl": True, "affine_model": "bilateral",
                 "bilateral_grid_shape": [16, 16, 8]},
     "losses": {"affine": 10.0},
     "optim": {"affine": {"lr": 1e-5, "lr_final": None,
                          "warmup_steps": 0}}},
    drop=("sampler.refresh_every", "sampler.refresh_downscale",
          "logging.vis_freq"))

# the YAMLs with SMPLNodes on drop the sampler refresh and vis_freq
_SMPL_DROP = ("sampler.refresh_every", "sampler.refresh_downscale",
              "logging.vis_freq")

# omnire.yaml: the appearance-code baseline, per-image affine codes with
# camera refinement (affine lr the default schedule)
OMNIRE_TREE = _variant(
    FLAGSHIP_TREE,
    {"trainer": {"use_smpl": True, "affine_model": "affine",
                 "use_camera_opt": True},
     "losses": {"affine": 1e-5}},
    drop=_SMPL_DROP)

# omnire_extended_cam.yaml: the same over 40,000 steps
OMNIRE_EXTENDED_CAM_TREE = _variant(
    OMNIRE_TREE, {"trainer": {"max_steps": 40000}})

# the neural grids: affine lr 2e-3 -> 1e-4 after a 1,000-step warm-up
_NEURAL_OPTIM = {"affine": {"lr": 2e-3, "lr_final": 1e-4,
                            "warmup_steps": 1000}}

# omnire_neuralbilateral.yaml: a 16 x 16 x 8 feature grid and MLP head
OMNIRE_NEURALBILATERAL_TREE = _variant(
    FLAGSHIP_TREE,
    {"trainer": {"use_smpl": True, "affine_model": "neural_bilateral",
                 "bilateral_grid_shape": [16, 16, 8]},
     "losses": {"affine": 100.0}, "optim": _NEURAL_OPTIM},
    drop=_SMPL_DROP)

# omnire_ms_neuralbilateral.yaml: the multi-scale feature pyramid
OMNIRE_MS_NEURALBILATERAL_TREE = _variant(
    FLAGSHIP_TREE,
    {"trainer": {"use_smpl": True,
                 "affine_model": "multiscale_neural_bilateral"},
     "losses": {"affine": 10.0}, "optim": _NEURAL_OPTIM},
    drop=_SMPL_DROP)

# omnire_cp4d.yaml: the rank-5 CP-4D grid
OMNIRE_CP4D_TREE = _variant(
    FLAGSHIP_TREE,
    {"trainer": {"use_smpl": True, "affine_model": "cp4d"},
     "losses": {"affine": 1e-5}},
    drop=_SMPL_DROP)

# omnire_ms_bilateral_extended.yaml: the flagship over 40,000 steps with
# the extended protocol's density control and no sampler refresh
OMNIRE_MS_BILATERAL_EXTENDED_TREE = _variant(
    FLAGSHIP_TREE,
    {"trainer": {"max_steps": 40000},
     "density": {"densify_grad_thresh": 0.0003,
                 "densify_size_thresh": 0.002, "reset_alpha_interval": 4000,
                 "stop_split_at": 20000, "stop_screen_size_at": 5000}},
    drop=_SMPL_DROP)

# the single-class trainers: no rigid, deformable or SMPL nodes, the
# affine codes with camera refinement, three cameras at full resolution
_SINGLE_CLASS = {
    "trainer": {"use_rigid": False, "use_deformable": False,
                "affine_model": "affine", "use_camera_opt": True},
    "data": {"cameras": [0, 1, 2], "downscale": 1, "num_cams": 3},
    "optim": {"affine": {"lr": 1e-5, "lr_final": None, "warmup_steps": 0}}}
_SINGLE_CLASS_DROP = ("render.radius_clip", "logging.vis_freq", "smpl",
                      "losses.max_depth", "losses.affine_inverse",
                      "losses.rigid_temporal", "losses.smpl_joint_smooth")

# pvg.yaml: the PVG background with its temporal model, temporal
# densification, the inverse-depth loss over the image, opacity entropy,
# inverse-depth smoothness and the velocity regulariser
PVG_TREE = _variant(
    FLAGSHIP_TREE,
    {**_SINGLE_CLASS,
     "trainer": {**_SINGLE_CLASS["trainer"], "background_model": "pvg",
                 "sh_degree_interval": 2000},
     "losses": {"mask": 1.0, "mask_loss_type": "safe_bce", "depth": 0.1,
                "depth_inverse": True, "depth_normalize": False,
                "depth_reduction": "mean_on_hw", "lidar_w_decay": 1.0,
                "opacity_entropy": 0.05, "inverse_depth_smoothness": 0.001,
                "affine": 1e-5},
     "background_reg": {"velocity_reg": {"w": 0.001}},
     "density": {"densify_grad_thresh": 0.0002, "densify_size_thresh": 0.01,
                 "cull_screen_size": 0.15, "split_screen_size": 0.05,
                 "stop_split_at": 20000,
                 "densify_until_num_points": 3000000,
                 "densify_t_grad_thresh": 0.002,
                 "densify_t_size_thresh": 0.01, "no_time_split": True},
     "pvg": {"cycle_length": 0.2, "time_interval": 0.02, "betas_init": 0.1,
             "enable_temporal_smoothing": True, "smooth_probability": 0.5,
             "distribution_span": 1.5},
     "res_schedule": {"double_steps": 5000, "downscale_times": 3},
     "optim": {**_SINGLE_CLASS["optim"], "logit_opacities": {"lr": 0.005}}},
    drop=_SINGLE_CLASS_DROP + ("sampler.refresh_every",
                               "sampler.refresh_downscale"))

# deformablegs.yaml: the DeformableGS background (a deformation network
# over every background slot), BCE sky loss, no background regulariser
DEFORMABLEGS_TREE = _variant(
    FLAGSHIP_TREE,
    {**_SINGLE_CLASS,
     "trainer": {**_SINGLE_CLASS["trainer"], "background_model": "deformgs"},
     "losses": {"mask_loss_type": "bce", "affine": 1e-5}},
    drop=_SINGLE_CLASS_DROP + (
        "sampler", "background_reg", "density.n_split_samples",
        "losses.lidar_w_decay", "losses.opacity_entropy",
        "losses.inverse_depth_smoothness"))

# synthetic.yaml: the generated scene of tools/common.build_synthetic_scene
# (a vanilla background, one rigid car, no pedestrians), SH 1 and a 32 x 32
# EnvLight over a 200-step run; not a variant of the flagship tree
SYNTHETIC_TREE = {
    "trainer": {"background_model": "vanilla", "use_rigid": True,
                "use_smpl": False, "sky_model": "envlight",
                "affine_model": "multiscale_bilateral", "sh_degree": 1,
                "envlight_resolution": 32, "max_steps": 200},
    "render": {"isect_capacity": 65536},
    "losses": {"rgb": 0.8, "ssim": 0.2, "mask": 0.05, "depth": 0.0},
    "density": {"refine_interval": 50, "warmup_steps": 10,
                "reset_alpha_interval": 100000},
    "data": {"synthetic": True, "width": 128, "height": 96,
             "num_frames": 6, "num_bg": 3000, "bg_capacity": 8192,
             "num_cams": 1},
    "sampler": {"buffer_ratio": 0.3},
    "logging": {"log_every": 20, "ckpt_every": 100},
}

# the dataset rigs of configs/datasets/<dataset>/<n>cams.yaml: dataset ->
# (camera counts, downscale, test_image_stride); a rig's tree names cameras
# 0 .. n-1
_RIGS = {"argoverse": ((1, 3, 5, 7), 2, 0), "kitti": ((1, 2), 1, 0),
         "nuplan": ((1, 3, 5, 8), 2, 0), "nuscenes": ((1, 3, 6), 3, 10),
         "pandaset": ((1, 3, 6), 2, 0), "waymo": ((1, 3, 5), 2, 0)}
DATASET_PRESETS = {
    f"{ds}/{n}cams": {"data": {"dataset": ds, "cameras": list(range(n)),
                               "downscale": down,
                               "test_image_stride": stride, "num_cams": n}}
    for ds, (counts, down, stride) in _RIGS.items() for n in counts}

PRESETS = {"omnire_ms_bilateral": FLAGSHIP_TREE,
           "omnire_bilateral": OMNIRE_BILATERAL_TREE,
           "omnire": OMNIRE_TREE,
           "omnire_extended_cam": OMNIRE_EXTENDED_CAM_TREE,
           "omnire_neuralbilateral": OMNIRE_NEURALBILATERAL_TREE,
           "omnire_ms_neuralbilateral": OMNIRE_MS_NEURALBILATERAL_TREE,
           "omnire_cp4d": OMNIRE_CP4D_TREE,
           "omnire_ms_bilateral_extended":
               OMNIRE_MS_BILATERAL_EXTENDED_TREE,
           "pvg": PVG_TREE,
           "deformablegs": DEFORMABLEGS_TREE,
           "synthetic": SYNTHETIC_TREE}

# background_init.capacity and trainer.max_steps of the same tree
FLAGSHIP_BG_CAPACITY = FLAGSHIP_TREE["background_init"]["capacity"]
FLAGSHIP_MAX_STEPS = FLAGSHIP_TREE["trainer"]["max_steps"]


def flagship_config(num_images: int, num_frames: int,
                    **overrides) -> TrainerConfig:
    """TrainerConfig of omnire_ms_bilateral for a scene's image and frame
    counts (scene scale 1); `overrides` replace single fields (e.g.
    isect_capacity)."""
    from .tools import common
    from .utils.config import wrap

    cfg = common.trainer_config_from(wrap(FLAGSHIP_TREE), num_images,
                                     num_frames, scene_scale=1.0)
    return dataclasses.replace(cfg, **overrides)
