"""Novel-view camera trajectories: the port's copy of
bilateral_driving_tpu/utils/trajectory.py (reference
project/utils/camera.py).

Smooth pose interpolation (slerp + lerp) through key poses selected from the
training cameras: `front_center_interp`, `s_curve`, `three_key_poses`
(camera.py:78-153), consumed by tools/render.py for fly-through videos.
Host-side numpy; the rotation conversions are the port's own
(core/transforms.py) on CPU tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import transforms


def _slerp(q0, q1, t):
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    d = np.dot(q0, q1)
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) \
        / np.sin(theta)


def _mat_to_quat(m):
    return transforms.rotmat_to_quat(
        torch.from_numpy(np.asarray(m, np.float32))).numpy()


def _quat_to_mat(q):
    return transforms.quat_to_rotmat(
        torch.from_numpy(np.asarray(q, np.float32))).numpy()


def interpolate_poses(key_poses: np.ndarray, target_frames: int) -> np.ndarray:
    """Piecewise slerp/lerp through (K, 4, 4) key poses -> (T, 4, 4)
    (camera.py:10-56)."""
    k = key_poses.shape[0]
    if k == 1:
        return np.repeat(key_poses, target_frames, axis=0)
    quats = _mat_to_quat(key_poses[:, :3, :3])
    out = []
    ts = np.linspace(0, k - 1, target_frames)
    for t in ts:
        i = min(int(np.floor(t)), k - 2)
        f = t - i
        q = _slerp(quats[i], quats[i + 1], f)
        pos = (1 - f) * key_poses[i, :3, 3] + f * key_poses[i + 1, :3, 3]
        m = np.eye(4)
        m[:3, :3] = _quat_to_mat(q)
        m[:3, 3] = pos
        out.append(m)
    return np.stack(out).astype(np.float32)


def front_center_interp(per_cam_poses: Dict[int, np.ndarray],
                        target_frames: int = 100) -> np.ndarray:
    """Every-4th front-cam frame as keys (camera.py:78-85)."""
    poses = per_cam_poses[0]
    stride = max(poses.shape[0] // 4, 1)
    return interpolate_poses(poses[::stride], target_frames)


def s_curve(per_cam_poses: Dict[int, np.ndarray],
            target_frames: int = 100) -> np.ndarray:
    """S-shaped sweep through the three front cameras (camera.py:86-99)."""
    f = per_cam_poses[0].shape[0]
    keys = np.stack([
        per_cam_poses[0][0],
        per_cam_poses[1][f // 4],
        per_cam_poses[0][f // 2],
        per_cam_poses[2][3 * f // 4],
        per_cam_poses[0][-1],
    ])
    return interpolate_poses(keys, target_frames)


def three_key_poses(per_cam_poses: Dict[int, np.ndarray],
                    target_frames: int = 100, rng=None) -> np.ndarray:
    """Start/middle/end keys; middle from a random side camera with
    half-slerped rotation (camera.py:100-153)."""
    rng = rng or np.random.RandomState(0)
    f = per_cam_poses[0].shape[0]
    start = per_cam_poses[0][0]
    cam = int(rng.choice([c for c in (1, 2) if c in per_cam_poses]))
    middle_src = per_cam_poses[cam][f // 2]
    q = _slerp(_mat_to_quat(start[:3, :3]), _mat_to_quat(middle_src[:3, :3]),
               0.5)
    middle = np.eye(4)
    middle[:3, :3] = _quat_to_mat(q)
    middle[:3, 3] = middle_src[:3, 3]
    keys = np.stack([start, middle, per_cam_poses[0][-1]])
    return interpolate_poses(keys, target_frames)


TRAJECTORY_GENERATORS = {
    "front_center_interp": front_center_interp,
    "s_curve": s_curve,
    "three_key_poses": three_key_poses,
}


def get_novel_trajectory(per_cam_poses: Dict[int, np.ndarray],
                         traj_type: str = "front_center_interp",
                         target_frames: int = 100) -> np.ndarray:
    return TRAJECTORY_GENERATORS[traj_type](per_cam_poses, target_frames)
