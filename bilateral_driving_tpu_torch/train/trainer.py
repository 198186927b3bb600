"""Scene forward pass: port of the render half of
bilateral_driving_tpu/train/trainer.py (`TrainerConfig` fields the forward
reads, `gaussian_classes`, `collect_gaussians`, `merge_statics`, `forward`).

forward = per-class Gaussians -> concat -> tiled rasterize -> EnvLight sky
compositing -> multi-scale bilateral appearance. Only the flagship
configuration (configs.flagship_config) is ported; other branches raise
NotImplementedError naming the slice they wait for. Losses, the optimizer
and densification belong to the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..models import bilateral, sky as sky_mod
from ..ops import pipeline
from ..ops.camera import viewmat_from_c2w
from ..scene import background, deformable, nodes, rigid


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    # class toggles
    background_model: str = "vanilla"      # vanilla (pvg | deformgs later)
    use_rigid: bool = False
    use_smpl: bool = False
    use_deformable: bool = False
    sky_model: str = "envlight"
    affine_model: str = "multiscale_bilateral"
    use_camera_opt: bool = False
    use_camera_perturb: bool = False

    # render
    near_plane: float = 0.1
    far_plane: float = 10000000.0
    radius_clip: float = 0.0
    antialiased: bool = False
    isect_capacity: int = 2 ** 20
    sh_degree: int = 3
    sh_degree_interval: int = 1000

    # appearance and sky
    ms_grid: tuple = bilateral.DEFAULT_MS_GRID
    guidance_factor: tuple = bilateral.DEFAULT_GUIDANCE_FACTOR
    envlight_resolution: int = 256
    num_images: int = 1
    num_frames: int = 1

    # dynamic-region loss weight: > 0 adds a dynamic-classes-only opacity
    # render to the training forward
    w_dynamic_region: float = 0.0


class SceneState(NamedTuple):
    """What rendering needs of a trained scene."""
    params: Any       # class name -> parameter dict (see core.gaussians)
    aux: Any          # class name -> per-point arrays (point_ids)
    masks: Any        # class name -> (C,) liveness
    step: int


def _later(what: str, slice_: str):
    return NotImplementedError(f"{what} is not ported yet: {slice_}")


def _check_flagship(cfg: TrainerConfig):
    if cfg.background_model != "vanilla":
        raise _later(f"background_model={cfg.background_model!r}",
                     "the background-variants slice")
    if cfg.use_smpl:
        raise _later("SMPLNodes", "the SMPL slice")
    if cfg.use_camera_opt or cfg.use_camera_perturb:
        raise _later("camera refinement", "the training slice")
    if cfg.sky_model != "envlight":
        raise _later(f"sky_model={cfg.sky_model!r}", "the sky-MLP slice")
    if cfg.affine_model != "multiscale_bilateral":
        raise _later(f"affine_model={cfg.affine_model!r}",
                     "the appearance-variants slice")


def gaussian_classes(cfg: TrainerConfig):
    out = []
    if cfg.background_model != "none":
        out.append("Background")
    if cfg.use_rigid:
        out.append("RigidNodes")
    if cfg.use_smpl:
        out.append("SMPLNodes")
    if cfg.use_deformable:
        out.append("DeformableNodes")
    return out


def merge_statics(statics, aux):
    """Combine immutable statics with per-point aux arrays per class."""
    return {name: {**statics.get(name, {}), **aux.get(name, {})}
            for name in set(statics) | set(aux)}


def collect_gaussians(cfg: TrainerConfig, params, statics, masks, cam_origin,
                      step: int, frame: int, t: float,
                      in_test_set: bool = False):
    """Per-class Gaussians + concat. `statics[name]` already holds that
    class's aux arrays (see merge_statics)."""
    _check_flagship(cfg)
    bundles = {"Background": background.gaussians(
        params["Background"], masks["Background"], cam_origin, step,
        background.BackgroundConfig(cfg.sh_degree, cfg.sh_degree_interval))}
    if cfg.use_rigid:
        bundles["RigidNodes"] = rigid.gaussians(
            params["RigidNodes"], statics["RigidNodes"], masks["RigidNodes"],
            cam_origin, step, frame, cfg.num_frames, in_test_set,
            rigid.RigidConfig(cfg.sh_degree, cfg.sh_degree_interval))
    if cfg.use_deformable:
        bundles["DeformableNodes"] = deformable.node_gaussians(
            params["DeformableNodes"], statics["DeformableNodes"],
            masks["DeformableNodes"], cam_origin, step, frame,
            cfg.num_frames, t, in_test_set,
            deformable.DeformableConfig(cfg.sh_degree,
                                        cfg.sh_degree_interval))
    return nodes.concat_bundles(bundles)


@torch.no_grad()
def forward(cfg: TrainerConfig, params, statics, masks, batch, step: int,
            in_test_set: bool = False, novel_view: bool = False,
            neighbor_idx=None):
    """Render one camera.

    batch: camera_to_world (4, 4), intrinsics (3, 3), pixels (H, W, 3),
    viewdirs (H, W, 3) world view directions, img_idx, frame_idx (ints) and
    normed_time (float). On test views, `neighbor_idx` lists the training
    images whose bilateral grids are averaged.
    """
    h, w = batch["pixels"].shape[:2]
    c2w = batch["camera_to_world"]
    viewmat = viewmat_from_c2w(c2w)
    frame = int(batch["frame_idx"])
    merged, labels = collect_gaussians(
        cfg, params, statics, masks, c2w[:3, 3], step, frame,
        float(batch["normed_time"]), in_test_set)

    rcfg = pipeline.RasterizeConfig(
        near_plane=cfg.near_plane, far_plane=cfg.far_plane,
        radius_clip=cfg.radius_clip, antialiased=cfg.antialiased,
        isect_capacity=cfg.isect_capacity)
    out = pipeline.rasterize(
        merged.means, merged.quats, merged.scales, merged.opacities,
        merged.rgbs, viewmat, batch["intrinsics"], w, h, rcfg)

    rgb_gaussians = torch.clamp(out["rgb"], max=1.0)
    opacity = out["alpha"]
    outputs = {
        "rgb_gaussians": rgb_gaussians,
        "depth": out["depth"],
        "opacity": opacity,
        "info": out["info"],
        "labels": labels,
    }

    if (cfg.w_dynamic_region > 0 and len(gaussian_classes(cfg)) > 1
            and not in_test_set and not novel_view):
        # dynamic-classes-only opacity: zero Background opacities render
        # exactly like leaving the Background out
        dyn_op = torch.where(labels != nodes.NODE_CLASS_IDS["Background"],
                             merged.opacities,
                             torch.zeros_like(merged.opacities))
        dyn = pipeline.rasterize(
            merged.means, merged.quats, merged.scales, dyn_op, merged.rgbs,
            viewmat, batch["intrinsics"], w, h, rcfg)
        outputs["Dynamic_opacity"] = dyn["alpha"]

    rgb_sky = sky_mod.envlight_color(params["Sky"], batch["viewdirs"])
    outputs["rgb_sky"] = rgb_sky
    original_rgb = rgb_gaussians + rgb_sky * (1.0 - opacity)
    outputs["original_rgb"] = original_rgb

    mats_list = bilateral.multiscale_affines(
        params["Affine"], original_rgb, int(batch["img_idx"]),
        cfg.guidance_factor,
        neighbor_idx=neighbor_idx if in_test_set else None)
    outputs["affine_mats"] = mats_list
    outputs["rgb"] = bilateral.compose_affines(mats_list, original_rgb)
    return outputs
