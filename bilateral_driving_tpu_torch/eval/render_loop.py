"""Render loop: port of bilateral_driving_tpu/eval/render_loop.py
(`render_images`, `aggregate_metrics`, `save_video`, `depth_visualizer`).

Test images (keys of `neighbor_map`) render with interpolated instance
poses, bilateral affines (and the neural grids' features) averaged over
their neighbouring training images, the affine codes' mean embedding and
no camera refinement; the rest render as training views. With metrics
on, each image gets the reference's per-image metric set
(eval/metrics.py), optionally the geometry metrics against the lidar
depth, after an optional least-squares colour correction; per-class
renders zero every other class's opacities.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import bilateral as bilateral_mod
from ..train import trainer as trainer_mod
from ..utils import visualization
from . import metrics as metrics_mod


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _ds(x, downscale):
    return x[::downscale, ::downscale] if downscale > 1 else x


@torch.no_grad()
def render_images(cfg, state: trainer_mod.SceneState, statics, data,
                  image_indices, neighbor_map: Optional[Dict] = None,
                  compute_metrics: bool = False, compute_geo: bool = False,
                  downscale: int = 1, decompose_classes: bool = False,
                  color_correct_eval: bool = False) -> Dict:
    """Render the given image indices of `data` (anything with
    `get_batch(idx, downscale)`; metrics also read its masks and lidar
    depth maps; unlike the JAX package's they are off unless asked for).
    Returns lists of tensors on the render device: rgbs
    (clipped to [0, 1], colour-corrected if asked), gt_rgbs, depths,
    opacities, sky_rgbs, num_isects and overflow; `metrics`, one dict per
    image; and with decompose_classes, `decomposed`: class -> renders."""
    full_statics = trainer_mod.merge_statics(statics, state.aux)
    out = {k: [] for k in ("rgbs", "gt_rgbs", "depths", "opacities",
                           "sky_rgbs", "num_isects", "overflow", "metrics")}
    classes = trainer_mod.gaussian_classes(cfg)
    if decompose_classes:
        out["decomposed"] = {n: [] for n in classes}
    for idx in image_indices:
        idx = int(idx)
        batch = data.get_batch(idx, downscale=downscale)
        nbrs = None if neighbor_map is None else neighbor_map.get(idx)
        o = trainer_mod.forward(cfg, state.params, full_statics, state.masks,
                                batch, state.step,
                                in_test_set=nbrs is not None,
                                neighbor_idx=nbrs)
        pred = torch.clamp(o["rgb"], 0.0, 1.0)
        gt = batch["pixels"]
        if color_correct_eval:
            # bilateral-paper-style eval: least-squares colour match before
            # metrics (video_utils_color_correction.py:201)
            pred = bilateral_mod.color_correct(pred, gt)
        depth = o["depth"][..., 0]
        out["rgbs"].append(pred)
        out["gt_rgbs"].append(gt)
        out["depths"].append(depth)
        out["opacities"].append(o["opacity"][..., 0])
        out["sky_rgbs"].append(o["rgb_sky"])
        out["num_isects"].append(o["info"]["num_isects"])
        out["overflow"].append(o["info"]["overflow"])

        if compute_metrics:
            pred_np, gt_np = _np(pred), _np(gt)
            m = metrics_mod.image_metrics(
                pred_np, gt_np,
                sky_mask=_ds(data.sky_masks[idx], downscale),
                dynamic_mask=_ds(data.dynamic_masks[idx], downscale),
                human_mask=_ds(data.human_masks[idx], downscale),
                vehicle_mask=_ds(data.vehicle_masks[idx], downscale),
                device=pred.device)
            if compute_geo and data.lidar_depth_maps is not None:
                depth_np = _np(depth)
                gt_depth = _ds(data.lidar_depth_maps[idx], downscale)
                m.update(metrics_mod.depth_metrics(depth_np, gt_depth))
                K = _np(batch["intrinsics"])
                c2w = _np(batch["camera_to_world"])
                pd = metrics_mod.depth_to_points(depth_np * (gt_depth > 0),
                                                 K, c2w)
                pg = metrics_mod.depth_to_points(gt_depth, K, c2w)
                m["chamfer"] = metrics_mod.chamfer_distance(pd, pg)
                m["chamfer_p97"] = metrics_mod.chamfer_distance(
                    pd, pg, percentile=97)
                m.update(metrics_mod.per_class_chamfer(
                    depth_np * (gt_depth > 0), gt_depth, K, c2w,
                    {"dynamic": _ds(data.dynamic_masks[idx], downscale),
                     "human": _ds(data.human_masks[idx], downscale),
                     "vehicle": _ds(data.vehicle_masks[idx], downscale)}))
            out["metrics"].append(m)

        if decompose_classes:
            for name in classes:
                mult = _class_opacity_mask(cfg, state.masks, name)
                oc = trainer_mod.forward(cfg, state.params, full_statics,
                                         state.masks, batch, state.step,
                                         opacity_multiplier=mult)
                out["decomposed"][name].append(
                    torch.clamp(oc["rgb_gaussians"], 0.0, 1.0))
    return out


def _class_opacity_mask(cfg, masks, keep_class):
    """Opacity multiplier zeroing all classes except `keep_class`
    (scene_graph.py:296-313 re-render path)."""
    return torch.cat([
        torch.full((masks[name].shape[0],), 1.0 if name == keep_class
                   else 0.0, device=masks[name].device)
        for name in trainer_mod.gaussian_classes(cfg)])


def aggregate_metrics(per_image: List[Dict]) -> Dict[str, float]:
    keys = set().union(*(m.keys() for m in per_image)) if per_image else set()
    out = {}
    for k in keys:
        vals = [m[k] for m in per_image if k in m and np.isfinite(m[k])]
        if vals:
            out[k] = float(np.mean(vals))
    if per_image and "lpips" not in out:
        # make the absence visible in every artifact
        out["lpips"] = None
        out["lpips_note"] = "null: no VGG weights found (the npz of " \
            "tools/export_lpips_weights.py at BILATERAL_LPIPS_WEIGHTS or " \
            "data/lpips_vgg.npz)"
    return out


def save_video(frames: List[np.ndarray], path: str):
    """Float [0, 1] (H, W, 3) frames as `<path without extension>/0000.png,
    0001.png, ...`: what the JAX package's save_video writes where no
    video codec is available (the card has no imageio). Returns the
    directory."""
    base = os.path.splitext(path)[0]
    os.makedirs(base, exist_ok=True)
    for i, f in enumerate(frames):
        visualization.save_png(np.asarray(f), os.path.join(base,
                                                           f"{i:04d}.png"))
    return base


def depth_visualizer(depth: np.ndarray, max_depth: float = 80.0) -> np.ndarray:
    """Turbo depth colour map (utils/visualization.py:477), near red and
    far blue, from the table in utils/visualization (matplotlib's
    cm.turbo)."""
    d = np.clip(depth / max_depth, 0, 1)
    return visualization.turbo(1.0 - d).astype(np.float32)
