"""Point-cloud and Gaussian export: port of
bilateral_driving_tpu/utils/export.py.

Counterparts of the reference's ply export (`export_points_to_ply`,
project/utils/misc.py; `export_gaussians_to_ply`, vanilla.py:466-473), the
render-depth -> synthetic lidar generator
(project/generate_lidar/generate_lidar_from_depth.py:95), its beam-pattern
sparsifier and the radar-detection box corners. Host-side numpy; Gaussian
parameters may be tensors on any device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core import sh as sh_lib


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def export_points_to_ply(path: str, points, colors=None) -> None:
    """ASCII ply of xyz (+ uchar rgb from colours in [0, 1])."""
    points = _np(points)
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            c = (np.clip(_np(colors), 0, 1) * 255).astype(np.uint8)
            for p, cc in zip(points, c):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{cc[0]} {cc[1]} {cc[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def export_gaussians_to_ply(path: str, params: dict, mask,
                            alpha_thresh: float = 0.0) -> int:
    """The live Gaussians whose opacity exceeds `alpha_thresh` as a
    coloured point cloud (vanilla.py:466-473: positions and DC colours,
    sh_lib.sh_to_rgb). Returns the number of points written."""
    logit = _np(params["logit_opacities"])[:, 0]
    op = 1.0 / (1.0 + np.exp(-logit))
    keep = _np(mask).astype(bool) & (op > alpha_thresh)
    means = _np(params["means"])[keep]
    colors = _np(sh_lib.sh_to_rgb(params["sh_dc"][:, 0, :].detach()))[keep]
    export_points_to_ply(path, means, np.clip(colors, 0, 1))
    return int(keep.sum())


def lidar_from_depth(depth: np.ndarray, K: np.ndarray, c2w: np.ndarray,
                     azimuth_res: float = 0.2, num_beams: int = 32,
                     fov_up: float = 10.0, fov_down: float = -30.0,
                     max_range: float = 80.0) -> np.ndarray:
    """Lidar-like returns from a rendered depth map, sampled along a
    spinning-beam pattern (generate_lidar_from_depth.py:95): world-frame
    xyz points (M, 3) float32."""
    depth, K, c2w = _np(depth), _np(K), _np(c2w)
    h, w = depth.shape
    elevs = np.deg2rad(np.linspace(fov_down, fov_up, num_beams))
    azims = np.deg2rad(np.arange(-60.0, 60.0, azimuth_res))
    el, az = np.meshgrid(elevs, azims, indexing="ij")
    # camera-frame ray directions (z forward, y down)
    dirs = np.stack([np.sin(az) * np.cos(el), -np.sin(el),
                     np.cos(az) * np.cos(el)], axis=-1).reshape(-1, 3)
    u = dirs[:, 0] / dirs[:, 2] * K[0, 0] + K[0, 2]
    v = dirs[:, 1] / dirs[:, 2] * K[1, 1] + K[1, 2]
    ok = (dirs[:, 2] > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    u, v, dirs = u[ok].astype(np.int64), v[ok].astype(np.int64), dirs[ok]
    z = depth[v, u]
    hit = (z > 0.1) & (z < max_range)
    pts_cam = dirs[hit] * (z[hit] / dirs[hit][:, 2])[:, None]
    return (pts_cam @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32)


def angular_subsample(points: np.ndarray, num_beams: int = 64,
                      azimuth_bins: int = 512, every: int = 1,
                      fov_half_deg: float = 45.0,
                      elev_top_deg: float = 2.0) -> np.ndarray:
    """A point cloud (N, C >= 3; xyz first, sensor frame) resampled onto a
    spinning lidar's (elevation, azimuth) grid, one return per cell (the
    last point wins, as the reference overwrites) and every `every`-th
    beam (generate_lidar_from_depth.py:6-41, depth2lidar.py:41)."""
    pts = _np(points)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    d = np.maximum(np.sqrt(x * x + y * y + z * z), 1e-6)
    r = np.maximum(np.sqrt(x * x + y * y), 1e-6)
    dphi = np.radians(2 * fov_half_deg) / azimuth_bins
    dtheta = np.radians(0.4 * 64.0 / num_beams)
    phi = np.radians(fov_half_deg) - np.arcsin(y / r)
    col = np.clip((phi / dphi).astype(np.int64), 0, azimuth_bins - 1)
    theta = np.radians(elev_top_deg) - np.arcsin(z / d)
    row = np.clip((theta / dtheta).astype(np.int64), 0, num_beams - 1)
    grid = np.full((num_beams, azimuth_bins), -1, np.int64)
    grid[row, col] = np.arange(pts.shape[0])
    keep = grid[::every].reshape(-1)
    return pts[keep[keep >= 0]]


def export_box_corners(frame_idx: int, instances_info: dict,
                       frame_instances: dict, world_to_sensor: np.ndarray,
                       output_path: str | None = None,
                       skip_ids=()) -> dict:
    """A frame's 3-D box corners in a sensor frame, as the reference's
    radar-detection JSON (generate_radar_detection.py:7-60):
    {obj_id: {"class_name", "bbox": 8 x 3 corners}}, written to
    <output_path>/<frame>.json when a path is given."""
    w2s = np.asarray(world_to_sensor)
    out = {}
    for obj_id in frame_instances.get(str(frame_idx), []):
        obj_id = str(obj_id)
        if obj_id in skip_ids:
            continue
        ann = instances_info[obj_id]["frame_annotations"]
        if frame_idx not in ann["frame_idx"]:
            continue
        k = ann["frame_idx"].index(frame_idx)
        o2w = np.asarray(ann["obj_to_world"][k], np.float64)
        l, w, h = [float(v) for v in ann["box_size"][k]]
        # the reference's corner order (visual_bbox_lidar.py:18-22): the
        # top face's ring (+h/2), then the bottom face's
        corners = np.array([
            [-l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2],
            [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2],
            [h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2],
        ]).T
        cw = corners @ o2w[:3, :3].T + o2w[:3, 3]
        cs = cw @ w2s[:3, :3].T + w2s[:3, 3]
        out[obj_id] = {
            "class_name": instances_info[obj_id].get("class_name", ""),
            "bbox": cs.tolist(),
        }
    if output_path is not None:
        os.makedirs(output_path, exist_ok=True)
        with open(os.path.join(output_path, f"{frame_idx:03d}.json"),
                  "w") as f:
            json.dump(out, f, indent=2)
    return out
