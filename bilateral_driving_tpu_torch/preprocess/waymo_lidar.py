"""Devkit-free math for Waymo range-image decoding and box projection
(port of bilateral_driving_tpu/preprocess/waymo_lidar.py).

Numpy counterparts of the Waymo devkit utilities the reference converter
leans on (reference `project/datasets/waymo/waymo_utils.py:59-403`, which in
turn wraps `waymo_open_dataset.utils.range_image_utils` /
`transform_utils` / `py_camera_model_ops` — all TensorFlow). Everything here
is plain numpy so it is unit-testable without the devkit or raw data; only
the proto *schema* (dataset_pb2) is needed at convert time, handled by
`waymo.py`.

Conventions (Waymo Open Dataset):
- vehicle frame: x forward, y left, z up;
- lidar range image: rows = beams (row 0 = highest inclination after the
  devkit's reverse), cols = azimuth sweep from +pi to -pi (minus the
  sensor's extrinsic yaw correction);
- camera frame: x forward (optical axis), y left, z up; pixel u grows along
  -y, v along -z.

The per-point work runs on `device` (default cuda): the range image's
cartesian points, the extrinsic and the rolling-shutter pixel poses
(`extract_point_cloud`), the ground fit's N x 3 products (`ground_mask`)
and the camera projection (`project_to_image`). Each is formed one
elementwise float64 op at a time (no matmul, so no TF32 and no summation
order of a library's), which gives the same bits on the CPU and on the
card and points within 1e-12 of the JAX package's numpy. Per-row and
per-column trigonometry, 4 x 4 inverses and the ground fit's mean,
covariance and 3 x 3 SVD stay on the host in numpy as there: the SVD's
sign picks which points count as ground, and a device solver may return
the other sign or other last bits.
"""
from __future__ import annotations

import numpy as np
import torch


def rotation_zyx(roll: np.ndarray, pitch: np.ndarray,
                 yaw: np.ndarray) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), batched over leading dims
    (transform_utils.get_rotation_matrix)."""
    roll, pitch, yaw = np.broadcast_arrays(roll, pitch, yaw)
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.empty(roll.shape + (3, 3), np.float64)
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


def poses_from_6dof(rpy_xyz: np.ndarray) -> np.ndarray:
    """(..., 6) [roll, pitch, yaw, x, y, z] -> (..., 4, 4) transforms
    (transform_utils.get_transform over the top-pose range image)."""
    rpy_xyz = np.asarray(rpy_xyz, np.float64)
    out = np.zeros(rpy_xyz.shape[:-1] + (4, 4), np.float64)
    out[..., :3, :3] = rotation_zyx(rpy_xyz[..., 0], rpy_xyz[..., 1],
                                    rpy_xyz[..., 2])
    out[..., :3, 3] = rpy_xyz[..., 3:6]
    out[..., 3, 3] = 1.0
    return out


def compute_inclination(inc_min: float, inc_max: float,
                        height: int) -> np.ndarray:
    """Uniform beam inclinations for lidars without a per-beam table
    (range_image_utils.compute_inclination): row centers bottom-up."""
    return ((0.5 + np.arange(height)) / height * (inc_max - inc_min)
            + inc_min)


def _affine(R, t, x, y, z):
    """R @ (x, y, z) + t for float64 tensors x, y, z and a (3, 3) numpy R
    with its (3,) t, or (..., 3, 3) and (..., 3) tensors: each row a sum of
    three products and the translation, in that order."""
    g = float if isinstance(R, np.ndarray) else (lambda a: a)
    return [x * g(R[..., i, 0]) + y * g(R[..., i, 1]) + z * g(R[..., i, 2])
            + g(t[..., i]) for i in range(3)]


def extract_point_cloud(range_img: np.ndarray, extrinsic: np.ndarray,
                        inclination: np.ndarray,
                        pixel_pose: np.ndarray | None = None,
                        frame_pose: np.ndarray | None = None,
                        device="cuda"):
    """Range image -> (points, origins), both (H, W, 3) float64 numpy in
    the VEHICLE frame.

    `inclination` is (H,) with row 0 = first range-image row (i.e. already
    reversed like the devkit does before calling). `pixel_pose` (H, W, 4, 4)
    is the TOP lidar's per-column rolling-shutter pose (vehicle->world);
    `frame_pose` the frame's vehicle->world, required with pixel_pose.
    Mirrors range_image_utils.extract_point_cloud_from_range_image +
    compute_range_image_cartesian (reference waymo_utils.py:59-217).
    """
    dev = torch.device(device)
    H, W = range_img.shape
    extrinsic = np.asarray(extrinsic, np.float64)
    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (np.arange(W, 0, -1) - 0.5) / W
    azimuth = (ratios * 2.0 - 1.0) * np.pi - az_correction        # (W,)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float64),   # noqa: E731
                                  device=dev)
    cos_az, sin_az = t(np.cos(azimuth))[None, :], t(np.sin(azimuth))[None, :]
    cos_in = t(np.cos(inclination))[:, None]
    sin_in = t(np.sin(inclination))[:, None]
    r = t(range_img)
    x = cos_az * cos_in * r
    y = sin_az * cos_in * r
    z = sin_in * r
    pts = _affine(extrinsic[:3, :3], extrinsic[:3, 3], x, y, z)
    origins = [torch.full_like(r, float(v)) for v in extrinsic[:3, 3]]

    if pixel_pose is not None:
        if frame_pose is None:
            raise ValueError("frame_pose must be set with pixel_pose")
        pp = t(pixel_pose)                                    # (H, W, 4, 4)
        pts = _affine(pp[..., :3, :3], pp[..., :3, 3], *pts)
        origins = _affine(pp[..., :3, :3], pp[..., :3, 3], *origins)
        w2v = np.linalg.inv(np.asarray(frame_pose, np.float64))
        pts = _affine(w2v[:3, :3], w2v[:3, 3], *pts)
        origins = _affine(w2v[:3, :3], w2v[:3, 3], *origins)
    return (torch.stack(pts, -1).cpu().numpy(),
            torch.stack(origins, -1).cpu().numpy())


def ground_mask(pts: np.ndarray, num_seed: int = 20, seed_margin: float = 1.2,
                n_iter: int = 10, dist_thresh: float = 0.3,
                device="cuda") -> np.ndarray:
    """Iterative plane-fit ground segmentation (reference
    waymo_utils.py:405-450 get_ground_np semantics): seed from the lowest
    points, fit a plane by PCA, re-select inliers, repeat. Returns (N, 1)
    bool like the reference (column stacked into the .bin).

    The seeds' mean, covariance and float32 3 x 3 SVD are the JAX
    package's numpy on the host; each point's height above the plane,
    x n0 + y n1 + z n2 of the float32 coordinates, is formed on `device`
    in float64 and rounded to float32 (numpy's float32 product may round
    a point within an ulp of the threshold to the other side)."""
    order = np.argsort(pts[:, 2])
    lpr = pts[order[:num_seed], 2].mean()
    seeds = pts[pts[:, 2] < lpr + seed_margin]
    p = torch.as_tensor(np.asarray(pts[:, :3]), device=torch.device(device))
    x, y, z = p.double().unbind(-1)
    below = torch.zeros(pts.shape[0], dtype=torch.bool, device=p.device)
    th_dist_d = 0.0
    for _ in range(n_iter):
        mean = seeds[:, :3].mean(axis=0)
        d = seeds[:, :3] - mean
        cov = (d[:, :, None] * d[:, None, :]).mean(axis=0)
        U, _, _ = np.linalg.svd(cov.astype(np.float32))
        normal = U[:, 2]
        th_dist_d = dist_thresh + normal.dot(mean)
        n0, n1, n2 = (float(v) for v in normal)
        result = (x * n0 + y * n1 + z * n2).to(p.dtype)
        below = result < float(th_dist_d)
        seeds = pts[below.cpu().numpy()]
    return below.cpu().numpy()[:, None]


def project_to_image(points_vehicle: np.ndarray, cam2v: np.ndarray,
                     intrinsic: np.ndarray, width: int,
                     height: int, device="cuda") -> np.ndarray:
    """Global-shutter projection of vehicle-frame points to pixels.

    Counterpart of the devkit's `py_camera_model_ops.world_to_image`
    as the reference uses it for mask drawing (waymo_utils.py:17-57 with
    GLOBAL_SHUTTER metadata): Waymo camera axes (x forward, y left, z up),
    Brown-Conrady distortion [k1, k2, p1, p2, k3] from intrinsic[4:9].
    Returns (N, 3) numpy of (u, v, ok); ok=0 for points behind the camera
    (the rolling-shutter timing refinement of the TF op is intentionally
    not replicated — boxes are drawn as axis-aligned speed rectangles
    downstream, waymo_preprocess.py:434-449)."""
    v2c = np.linalg.inv(np.asarray(cam2v, np.float64))
    q = torch.as_tensor(np.asarray(points_vehicle, np.float64),
                        device=torch.device(device))
    x, y, z = _affine(v2c[:3, :3], v2c[:3, 3], *q.unbind(-1))
    ok = x > 1e-6
    xs = torch.where(ok, x, torch.ones_like(x))
    # normalized image coords: u along -y/x, v along -z/x
    un, vn = -y / xs, -z / xs
    fx, fy, cx, cy = (float(v) for v in intrinsic[0:4])
    k1, k2, p1, p2, k3 = (float(v) for v in intrinsic[4:9])
    r2 = un * un + vn * vn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    ud = un * radial + 2.0 * p1 * un * vn + p2 * (r2 + 2.0 * un * un)
    vd = vn * radial + p1 * (r2 + 2.0 * vn * vn) + 2.0 * p2 * un * vn
    u = fx * ud + cx
    v = fy * vd + cy
    return torch.stack([u, v, ok.double()], -1).cpu().numpy()


def box_corners_3d(center: np.ndarray, lwh: np.ndarray,
                   heading: float) -> np.ndarray:
    """Upright 3-D box corners, (8, 3) in the box's parent frame
    (box_utils.get_upright_3d_box_corners semantics: z-axis yaw only)."""
    l, w, h = lwh
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64) * (l / 2)
    sy = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64) * (w / 2)
    sz = np.array([-1, -1, -1, -1, 1, 1, 1, 1], np.float64) * (h / 2)
    c, s = np.cos(heading), np.sin(heading)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
    return np.stack([sx, sy, sz], axis=-1) @ R.T + np.asarray(center)


def draw_speed_mask(mask: np.ndarray, boxes, cam2v: np.ndarray,
                    intrinsic: np.ndarray, device="cuda") -> np.ndarray:
    """Accumulate per-box speed rectangles into `mask` (H, W) by max
    (waymo_preprocess.py:399-449): project the 8 corners, skip the box if
    any corner is behind the camera, clip to bounds, max-pool the speed.
    Every box's corners are projected in one call on `device`.

    `boxes`: iterable of (corners_vehicle (8,3), speed float)."""
    H, W = mask.shape
    boxes = list(boxes)
    if not boxes:
        return mask
    uvo_all = project_to_image(np.concatenate([c for c, _ in boxes]), cam2v,
                               intrinsic, W, H, device).reshape(-1, 8, 3)
    for uvo, (_, speed) in zip(uvo_all, boxes):
        if not np.all(uvo[:, 2] > 0):
            continue
        u = np.clip(uvo[:, 0], 0, W)
        v = np.clip(uvo[:, 1], 0, H)
        if u.max() - u.min() == 0 or v.max() - v.min() == 0:
            continue
        y0, y1 = int(v.min()), int(v.max())
        x0, x1 = int(u.min()), int(u.max())
        mask[y0:y1, x0:x1] = np.maximum(mask[y0:y1, x0:x1], speed)
    return mask
