"""Evaluation metrics: port of bilateral_driving_tpu/eval/metrics.py
(reference project/models/video_utils.py:98-619).

PSNR and SSIM on full images; masked variants (non-sky, dynamic-only,
human-only, vehicle-only PSNR and SSIM); geometric metrics: chamfer distance
between depth-backprojected point clouds (all, percentile-trimmed, per
class) and depth RMSE / median squared error. Inputs are host numpy arrays,
as in the JAX package; SSIM runs the training loss's SSIM on the CPU.

LPIPS (eval/lpips.py) needs VGG weights that the repository does not hold:
`lpips` computes it on the evaluation's device from the npz that
BILATERAL_LPIPS_WEIGHTS or data/lpips_vgg.npz names
(tools/export_lpips_weights.py writes it), and returns None without one.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..train import losses as loss_lib
from . import lpips as lpips_mod


def psnr(pred, gt, mask=None) -> float:
    if mask is None:
        mse = np.mean((pred - gt) ** 2)
    else:
        m = mask[..., None] if mask.ndim == pred.ndim - 1 else mask
        num = np.sum(((pred - gt) ** 2) * m)
        den = np.sum(np.broadcast_to(m, pred.shape))
        mse = num / np.maximum(den, 1.0)
    return float(-10.0 * np.log10(np.maximum(mse, 1e-12)))


def ssim(pred, gt, mask=None) -> float:
    """Full-image SSIM; the reference's masked SSIM multiplies images by the
    mask before comparison (video_utils.py:291-361)."""
    if mask is not None:
        pred = pred * mask[..., None]
        gt = gt * mask[..., None]
    with torch.no_grad():
        return float(loss_lib.ssim(
            torch.from_numpy(np.ascontiguousarray(pred, np.float32)),
            torch.from_numpy(np.ascontiguousarray(gt, np.float32))))


def _find_lpips_weights():
    for c in (os.environ.get("BILATERAL_LPIPS_WEIGHTS", ""),
              "data/lpips_vgg.npz"):
        if c and os.path.exists(c):
            return c
    return None


# (weights path, its mtime, device) -> LPIPSParams
_lpips_params: Dict[tuple, lpips_mod.LPIPSParams] = {}


def lpips(pred, gt, device="cpu") -> Optional[float]:
    """LPIPS of two (H, W, 3) images in [0, 1] on `device` in float32, or
    None where no weights file is found."""
    path = _find_lpips_weights()
    if path is None:
        return None
    key = (os.path.abspath(path), os.path.getmtime(path), str(device))
    if key not in _lpips_params:
        _lpips_params[key] = lpips_mod.load_weights_npz(path, device,
                                                        torch.float32)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    with torch.no_grad():
        return float(lpips_mod.lpips(_lpips_params[key], t(pred), t(gt)))


def depth_to_points(depth: np.ndarray, K: np.ndarray,
                    c2w: np.ndarray) -> np.ndarray:
    """Backproject a depth map to a world point cloud
    (utils/chamfer_distance.py:50-75)."""
    h, w = depth.shape
    v, u = np.mgrid[:h, :w]
    z = depth
    x = (u + 0.5 - K[0, 2]) / K[0, 0] * z
    y = (v + 0.5 - K[1, 2]) / K[1, 1] * z
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    valid = depth.reshape(-1) > 1e-3
    pts = pts[valid]
    return pts @ c2w[:3, :3].T + c2w[:3, 3]


def _nn_dists(a: np.ndarray, b: np.ndarray, chunk=4096) -> np.ndarray:
    """min distance from each a to b, chunked host-side."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((0,))
    out = []
    bb = np.sum(b * b, -1)
    for i in range(0, a.shape[0], chunk):
        q = a[i:i + chunk]
        d2 = np.sum(q * q, -1, keepdims=True) - 2 * q @ b.T + bb[None]
        out.append(np.sqrt(np.maximum(d2.min(1), 0)))
    return np.concatenate(out)


def chamfer_distance(a: np.ndarray, b: np.ndarray,
                     percentile: Optional[float] = None) -> float:
    """Symmetric chamfer; optional percentile trimming (video_utils.py:
    363-536: all + 99/97/95-percentile variants)."""
    da = _nn_dists(a, b)
    db = _nn_dists(b, a)
    if percentile is not None:
        da = da[da <= np.percentile(da, percentile)] if da.size else da
        db = db[db <= np.percentile(db, percentile)] if db.size else db
    if da.size == 0 or db.size == 0:
        return float("nan")
    return float(da.mean() + db.mean())


def per_class_chamfer(pred_depth, gt_depth, K, c2w, class_masks: Dict,
                      percentile=None) -> Dict[str, float]:
    """Chamfer restricted to semantic regions (video_utils.py:363-536
    per-class variants): depth maps masked per class before backprojection."""
    out = {}
    for name, m in class_masks.items():
        if m is None or m.sum() == 0:
            continue
        pd = depth_to_points(pred_depth * m, K, c2w)
        pg = depth_to_points(gt_depth * m, K, c2w)
        out[f"chamfer_{name}"] = chamfer_distance(pd, pg,
                                                  percentile=percentile)
    return out


def depth_metrics(pred_depth: np.ndarray, gt_depth: np.ndarray,
                  max_depth: float = 80.0) -> Dict[str, float]:
    """RMSE + median squared error on lidar hits (video_utils.py:399-410)."""
    valid = (gt_depth > 0.01) & (gt_depth < max_depth)
    if valid.sum() == 0:
        return {"depth_rmse": float("nan"), "depth_med_se": float("nan")}
    err2 = (pred_depth[valid] - gt_depth[valid]) ** 2
    return {"depth_rmse": float(np.sqrt(err2.mean())),
            "depth_med_se": float(np.median(err2))}


def image_metrics(pred, gt, sky_mask=None, dynamic_mask=None,
                  human_mask=None, vehicle_mask=None,
                  device="cpu") -> Dict[str, float]:
    """The reference's full per-image metric set (video_utils.py:273-361);
    LPIPS on `device`."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    out = {"psnr": psnr(pred, gt), "ssim": ssim(pred, gt)}
    lp = lpips(pred, gt, device)
    if lp is not None:
        out["lpips"] = lp
    if sky_mask is not None:
        occ = 1.0 - np.asarray(sky_mask)
        out["non_sky_psnr"] = psnr(pred, gt, occ)
        out["non_sky_ssim"] = ssim(pred, gt, occ)
    for name, m in [("dynamic", dynamic_mask), ("human", human_mask),
                    ("vehicle", vehicle_mask)]:
        if m is not None and np.asarray(m).sum() > 0:
            m = np.asarray(m)
            out[f"{name}_psnr"] = psnr(pred, gt, m)
            out[f"{name}_ssim"] = ssim(pred, gt, m)
    return out
