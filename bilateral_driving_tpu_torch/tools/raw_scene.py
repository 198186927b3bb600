"""Write a raw nuScenes log from a seed, at the published sensor sizes.

    python -m bilateral_driving_tpu_torch.tools.raw_scene RAW_ROOT \
        [--seed 0] [--scale 1]
    python -m bilateral_driving_tpu_torch.tools.raw_scene --humanpose \
        PROCESSED_SCENE [--seed 0]

The first form writes a `v1.0-mini`-layout log under RAW_ROOT, the input
of `preprocess.cli --dataset nuscenes` (preprocess/nuscenes.py): the
relational tables (scene, sample, sample_data, ego_pose,
calibrated_sensor, sensor, sample_annotation, instance, category) and the
sensor files, with nuScenes' sizes and rates (Caesar et al., CVPR 2020):

- six cameras at 1600 x 900 (JPEG), 12 Hz, placed and calibrated about as
  the nuScenes rig is (yaw 0, +-55, +-110 and 180 degrees, fx 809-1273);
- LIDAR_TOP sweeps of 34,720 points (32 beams x 1,085 azimuths) of
  float32 (x, y, z, intensity, ring) at 20 Hz: the ground, and walls past
  it;
- NUM_KEYFRAMES keyframes 0.5 s apart (11 frames after the converter's
  interpolation to 10 Hz), the ego driving a gentle curve at 8 m/s;
- ANNOTATIONS per keyframe (nuScenes averages 1.4M boxes over 40k
  keyframes): cars, trucks and a bus in the lanes, parked cars,
  pedestrians walking the sidewalks, a bicycle and static barriers, each
  instance annotated at every keyframe; boxes lie all round the ego, so
  some cross a camera's plane and some fall outside a camera's image.

The second form writes the tracker outputs `humanpose/<cam>.pkl` that
preprocess/smpl_track.py matches to a converted scene's pedestrians: for
every camera one entry per frame in the 4D-Humans/PHALP frame schema
({"tid", "bbox", "tracked_time", "smpl", "camera"}), a box per pedestrian
the camera sees (the projected ground-truth box, jittered), random SMPL
poses (rotation matrices near a standing pose), some frames missed or
coasted. A tool of the port's own, run where PIL is installed.

`--scale k` divides the image sizes, focal lengths, principal points and
the lidar's azimuth count by k: a small log of the same scene (tests).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, List

import numpy as np

from ..preprocess import nuscenes, smpl_track

WIDTH, HEIGHT = 1600, 900
BEAMS, AZIMUTHS = 32, 1085                  # HDL-32E: 34,720 points a sweep
ELEVATION_DEG = (-30.67, 10.67)
NUM_KEYFRAMES = 3
KEYFRAME_US, CAMERA_US, LIDAR_US = 500_000, 83_333, 50_000
SPEED, YAW_RATE = 8.0, 0.05                 # m/s, rad/s
T0 = 1_533_151_603_547_590
# channel -> (yaw deg, translation in the ego frame, fx, cx, cy)
CAMERA_RIG = {
    "CAM_FRONT": (0.0, (1.70, 0.02, 1.51), 1266.4, 816.3, 491.5),
    "CAM_FRONT_LEFT": (55.0, (1.52, 0.49, 1.51), 1272.6, 826.6, 479.8),
    "CAM_FRONT_RIGHT": (-55.0, (1.55, -0.49, 1.50), 1260.8, 808.0, 495.3),
    "CAM_BACK_LEFT": (110.0, (1.04, 0.48, 1.59), 1256.7, 792.1, 492.8),
    "CAM_BACK_RIGHT": (-110.0, (1.01, -0.48, 1.56), 1259.5, 807.3, 501.2),
    "CAM_BACK": (180.0, (0.03, 0.00, 1.58), 809.2, 829.2, 481.8),
}
LIDAR_T = (0.94, 0.0, 1.84)
# (category, count, size (w, l, h), where): where is "lane", "parked",
# "sidewalk", "bike lane" or "roadside"; 36 instances
OBJECTS = [
    ("vehicle.car", 14, (1.9, 4.6, 1.6), "lane"),
    ("vehicle.car", 4, (1.9, 4.5, 1.5), "parked"),
    ("vehicle.truck", 3, (2.5, 7.5, 3.0), "lane"),
    ("vehicle.bus.rigid", 1, (2.9, 11.5, 3.4), "lane"),
    ("human.pedestrian.adult", 8, (0.65, 0.7, 1.75), "sidewalk"),
    ("vehicle.bicycle", 1, (0.6, 1.8, 1.4), "bike lane"),
    ("movable_object.barrier", 5, (2.5, 0.5, 1.0), "roadside"),
]
ANNOTATIONS = sum(n for _, n, _, _ in OBJECTS)


def _rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _quat(R: np.ndarray) -> List[float]:
    return [float(v) for v in smpl_track._mat_to_quat(R)]


def ego_pose(us: int):
    """The ego's (translation, wxyz rotation) at a timestamp: a circle arc
    at SPEED and YAW_RATE from the origin."""
    t = (us - T0) * 1e-6
    yaw = YAW_RATE * t
    x = SPEED / YAW_RATE * np.sin(yaw)
    y = SPEED / YAW_RATE * (1.0 - np.cos(yaw))
    return [float(x), float(y), 0.0], _quat(_rot_z(yaw))


def _camera_rotation(yaw_deg: float) -> np.ndarray:
    """OpenCV camera axes (x right, y down, z forward) in the ego frame
    (x forward, y left, z up) for a camera looking at `yaw_deg`."""
    y = np.deg2rad(yaw_deg)
    fwd = np.array([np.cos(y), np.sin(y), 0.0])
    right = np.array([np.sin(y), -np.cos(y), 0.0])
    return np.stack([right, np.array([0.0, 0.0, -1.0]), fwd], axis=1)


def _image(rng, ci: int, width: int, height: int) -> np.ndarray:
    """A camera's base picture: sky over road, vertical stripes of
    buildings, smooth enough to compress like a photograph."""
    ys = np.linspace(0.0, 1.0, height)[:, None, None]
    xs = np.linspace(0.0, 1.0, width)[None, :, None]
    sky = np.array([120, 160, 225]) * (1.0 - 0.4 * ys)
    road = np.array([90, 90, 95]) * (0.7 + 0.5 * ys)
    phase = rng.uniform(0, 2 * np.pi, 3)
    walls = 140 + 60 * np.sin(2 * np.pi * (3 + ci) * xs + phase)
    img = np.where(ys < 0.42, sky, np.where(ys < 0.55, walls, road))
    return np.clip(img, 0, 255).astype(np.uint8)


def _objects(rng):
    """The instances: (category, size (w, l, h), x0, y, speed, yaw), each
    moving along its heading at its speed from (x0, y) at T0. Placed one
    after another where no box placed before stands within 2 m along the
    road in the same band."""
    out = []
    for cat, n, size, where in OBJECTS:
        for _ in range(n):
            for _ in range(100):
                if where == "lane":
                    y0 = rng.choice([-3.5, 3.5, 7.0])
                    x0, v = rng.uniform(-35.0, 60.0), rng.uniform(4.0, 11.0)
                    yaw = 0.0 if y0 < 7 else np.pi
                elif where == "parked":
                    y0 = rng.choice([-9.5, 10.5])
                    x0, v, yaw = rng.uniform(-20.0, 45.0), 0.0, 0.0
                elif where == "sidewalk":
                    y0 = rng.choice([-12.0, 13.0])
                    x0, v = rng.uniform(-15.0, 35.0), rng.uniform(0.8, 1.6)
                    yaw = rng.choice([0.0, np.pi])
                elif where == "bike lane":
                    x0, y0, v, yaw = rng.uniform(8.0, 20.0), -6.0, 4.5, 0.0
                else:
                    y0 = rng.choice([-7.5, 8.5])
                    x0, v, yaw = rng.uniform(10.0, 45.0), 0.0, np.pi / 2
                if all(abs(y0 - o[3]) > 2.5 or abs(x0 - o[2]) > 2.0 + (
                        size[1] + o[1][1]) / 2 for o in out):
                    break
            out.append((cat, size, x0, y0, v, yaw))
    return out


def _box_at(obj, us: int):
    """An instance's box centre (world) and heading at a timestamp."""
    _, size, x0, y0, v, yaw = obj
    t = (us - T0) * 1e-6
    return (np.array([x0 + v * np.cos(yaw) * t, y0 + 0.1 * t,
                      size[2] / 2.0]), yaw + 0.01 * t)


def _lidar_sweep(rng, us: int, objects, azimuths: int = AZIMUTHS
                 ) -> np.ndarray:
    """(32 x azimuths, 5) float32 points (x, y, z, intensity, ring) in the
    lidar frame: every beam cast from the lidar's pose at `us` to the
    nearest of the ground (z = 0), a wall 20-60 m away and the instances'
    boxes at that time."""
    elev = np.deg2rad(np.linspace(*ELEVATION_DEG, BEAMS))[:, None]
    az = np.linspace(-np.pi, np.pi, azimuths, endpoint=False)[None, :]
    dirs = np.stack(np.broadcast_arrays(np.cos(elev) * np.cos(az),
                                        np.cos(elev) * np.sin(az),
                                        np.sin(elev)), -1).reshape(-1, 3)
    trans, rot = ego_pose(us)
    ego_r = smpl_track._quat_to_mat(np.asarray(rot))
    r_wl = ego_r @ _rot_z(-np.pi / 2)
    origin = ego_r @ np.asarray(LIDAR_T) + np.asarray(trans)
    d = dirs @ r_wl.T                                        # world rays
    t = np.where(d[:, 2] < -1e-3, -origin[2] / np.minimum(d[:, 2], -1e-3),
                 np.inf)
    wall = np.repeat(rng.uniform(20.0, 60.0, (1, azimuths)), BEAMS, 0)
    t = np.minimum(t, wall.reshape(-1) / np.cos(np.repeat(elev, azimuths)))
    for obj in objects:
        centre, yaw = _box_at(obj, us)
        w, l, h = obj[1]
        half = np.array([l, w, h]) / 2.0
        r_ob = _rot_z(-yaw)
        o = r_ob @ (origin - centre)
        db = d @ r_ob.T
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (-half - o) / db
            t2 = (half - o) / db
        near = np.nanmax(np.minimum(t1, t2), axis=1)
        far = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (near <= far) & (near > 0.5)
        t = np.where(hit & (near < t), near, t)
    t = t * (1.0 + 0.002 * rng.standard_normal(t.shape))
    pts = np.concatenate([
        dirs * t[:, None], rng.uniform(0, 255, (t.shape[0], 1)),
        np.repeat(np.arange(BEAMS), azimuths)[:, None]], 1)
    return pts.astype(np.float32)


def write_raw_log(root: str, seed: int = 0, scale: int = 1) -> str:
    """Write the log's tables and sensor files under `root`; returns it.
    `scale` divides the camera and lidar sizes (module docstring)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    width, height = WIDTH // scale, HEIGHT // scale
    tables = {name: [] for name in nuscenes.Tables.NAMES}
    key_us = [T0 + KEYFRAME_US * k for k in range(NUM_KEYFRAMES)]
    end_us = key_us[-1]
    objects = _objects(rng)
    tables["scene"].append({
        "token": "scene0", "name": "scene-0001", "nbr_samples":
            NUM_KEYFRAMES, "first_sample_token": "sample0",
        "last_sample_token": f"sample{NUM_KEYFRAMES - 1}",
        "description": "seeded raw log"})
    for k, us in enumerate(key_us):
        tables["sample"].append({
            "token": f"sample{k}", "timestamp": us, "scene_token": "scene0",
            "prev": f"sample{k - 1}" if k else "",
            "next": f"sample{k + 1}" if k + 1 < NUM_KEYFRAMES else ""})

    def nearest_sample(us: int) -> str:
        return f"sample{int(np.argmin([abs(us - k) for k in key_us]))}"

    def add_sweeps(channel, stamps, cal_token, write, ext, size):
        for j, us in enumerate(stamps):
            key = min(abs(us - k) for k in key_us) < (
                CAMERA_US if ext == "jpg" else LIDAR_US) / 2
            sub = "samples" if key else "sweeps"
            fn = f"{sub}/{channel}/{channel}_{us}.{ext}"
            os.makedirs(os.path.join(root, sub, channel), exist_ok=True)
            write(os.path.join(root, fn), j)
            tok = f"{channel}_{j}"
            trans, rot = ego_pose(us)
            tables["ego_pose"].append({"token": f"ep_{tok}", "timestamp": us,
                                       "translation": trans,
                                       "rotation": rot})
            tables["sample_data"].append({
                "token": f"sd_{tok}", "sample_token": nearest_sample(us),
                "ego_pose_token": f"ep_{tok}",
                "calibrated_sensor_token": cal_token, "timestamp": us,
                "fileformat": "jpg" if ext == "jpg" else "pcd",
                "is_key_frame": bool(key), "height": size[1],
                "width": size[0], "filename": fn, "prev": "", "next": ""})

    for ci, (channel, (yaw, trans, fx, cx, cy)) in enumerate(
            CAMERA_RIG.items()):
        tables["sensor"].append({"token": f"sensor_{channel}",
                                 "channel": channel, "modality": "camera"})
        tables["calibrated_sensor"].append({
            "token": f"cal_{channel}", "sensor_token": f"sensor_{channel}",
            "translation": list(trans),
            "rotation": _quat(_camera_rotation(yaw)),
            "camera_intrinsic": [[fx / scale, 0.0, cx / scale],
                                 [0.0, fx / scale, cy / scale],
                                 [0.0, 0.0, 1.0]]})
        base = _image(rng, ci, width, height)
        # cameras fire one after another as the lidar sweeps past them
        offset = 8_000 * ci
        stamps = list(range(T0 + offset, end_us + CAMERA_US, CAMERA_US))

        def write_jpg(path, j, base=base):
            Image.fromarray(np.roll(base, -12 * j // scale, axis=1)).save(
                path)

        add_sweeps(channel, stamps, f"cal_{channel}", write_jpg, "jpg",
                   (width, height))
    tables["sensor"].append({"token": "sensor_LIDAR_TOP",
                             "channel": "LIDAR_TOP", "modality": "lidar"})
    tables["calibrated_sensor"].append({
        "token": "cal_LIDAR_TOP", "sensor_token": "sensor_LIDAR_TOP",
        "translation": list(LIDAR_T), "rotation": _quat(_rot_z(-np.pi / 2)),
        "camera_intrinsic": []})
    add_sweeps("LIDAR_TOP", list(range(T0, end_us + 1, LIDAR_US)),
               "cal_LIDAR_TOP",
               lambda path, j: _lidar_sweep(
                   rng, T0 + LIDAR_US * j, objects, AZIMUTHS // scale
               ).tofile(path), "pcd.bin", (0, 0))

    cats = {}
    for ii, obj in enumerate(objects):
        cat, size = obj[:2]
        if cat not in cats:
            cats[cat] = f"cat{len(cats)}"
            tables["category"].append({"token": cats[cat], "name": cat,
                                       "description": ""})
        tables["instance"].append({
            "token": f"inst{ii:03d}", "category_token": cats[cat],
            "nbr_annotations": len(key_us)})
        for k, us in enumerate(key_us):
            centre, yaw = _box_at(obj, us)
            trans, rot = [float(v) for v in centre], _quat(_rot_z(yaw))
            tables["sample_annotation"].append({
                "token": f"ann{ii:03d}_{k}", "sample_token": f"sample{k}",
                "instance_token": f"inst{ii:03d}", "translation": trans,
                "rotation": rot, "size": list(size),
                "prev": f"ann{ii:03d}_{k - 1}" if k else "",
                "next": (f"ann{ii:03d}_{k + 1}" if k + 1 < len(key_us)
                         else "")})
    os.makedirs(os.path.join(root, "v1.0-mini"), exist_ok=True)
    for name, rows in tables.items():
        with open(os.path.join(root, "v1.0-mini", f"{name}.json"), "w") as f:
            json.dump(rows, f)
    return root


def _rodrigues(v: np.ndarray) -> np.ndarray:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrices."""
    th = np.linalg.norm(v, axis=-1, keepdims=True)
    k = v / np.maximum(th, 1e-12)
    kx = np.zeros(v.shape[:-1] + (3, 3))
    kx[..., 0, 1], kx[..., 0, 2] = -k[..., 2], k[..., 1]
    kx[..., 1, 0], kx[..., 1, 2] = k[..., 2], -k[..., 0]
    kx[..., 2, 0], kx[..., 2, 1] = -k[..., 1], k[..., 0]
    th = th[..., None]
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def write_humanpose(scene_dir: str, seed: int = 0) -> Dict[int, str]:
    """Write `humanpose/<cam>.pkl` for every camera of a converted scene;
    returns the paths by camera."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    cams = sorted(int(f.split(".")[0])
                  for f in os.listdir(os.path.join(scene_dir, "intrinsics")))
    img_dir = os.path.join(scene_dir, "images")
    sizes = {}
    for cam in cams:
        first = sorted(f for f in os.listdir(img_dir)
                       if f.endswith(f"_{cam}.jpg"))[0]
        with Image.open(os.path.join(img_dir, first)) as im:
            sizes[cam] = im.size
    num_frames = len([f for f in os.listdir(os.path.join(
        scene_dir, "extrinsics")) if f.endswith(f"_{cams[0]}.txt")])
    gt = smpl_track.gt_tracks_from_scene(scene_dir, cams, sizes,
                                         num_frames=num_frames)
    tids = sorted({t for c in gt.values() for f in c.values()
                   for t in f["extra_data"]["gt_track_id"]})
    # one body per pedestrian: a standing pose with small joint angles,
    # drifting a little from frame to frame
    body = {t: (0.15 * rng.standard_normal((smpl_track.NUM_BODY_JOINTS, 3)),
                0.5 * rng.standard_normal(10)) for t in tids}
    os.makedirs(os.path.join(scene_dir, "humanpose"), exist_ok=True)
    paths = {}
    for cam in cams:
        raw = {}
        for fi in range(num_frames):
            frame = gt[cam][fi]
            rec = {"tid": [], "bbox": [], "tracked_time": [], "smpl": [],
                   "camera": []}
            for tid, box in zip(frame["extra_data"]["gt_track_id"],
                                frame["gt_bbox"]):
                if rng.random() < 0.1:
                    continue                      # a missed detection
                pose, betas = body[tid]
                drift = 0.02 * rng.standard_normal(pose.shape)
                orient = np.array([np.pi, 0.0, 0.0]) + 0.05 * \
                    rng.standard_normal(3)
                rec["tid"].append(100 + tid)
                rec["bbox"].append((np.asarray(box) * (
                    1.0 + 0.03 * rng.standard_normal(4))).tolist())
                rec["tracked_time"].append(int(rng.random() < 0.05))
                rec["smpl"].append({
                    "global_orient": _rodrigues(orient)[None].astype(
                        np.float32),
                    "body_pose": _rodrigues(pose + drift).astype(np.float32),
                    "betas": betas.astype(np.float32)})
                rec["camera"].append(rng.uniform(
                    [0.5, -0.5, -0.5], [1.5, 0.5, 0.5]).astype(np.float32))
            raw[f"{fi:03d}_{cam}.jpg"] = rec
        paths[cam] = os.path.join(scene_dir, "humanpose", f"{cam}.pkl")
        with open(paths[cam], "wb") as f:
            pickle.dump(raw, f)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="raw log root, or with --humanpose a "
                                "converted scene directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=int, default=1,
                   help="divide the camera and lidar sizes by this")
    p.add_argument("--humanpose", action="store_true",
                   help="write the tracker outputs of a converted scene")
    args = p.parse_args(argv)
    if args.humanpose:
        for cam, path in write_humanpose(args.path, args.seed).items():
            print(f"camera {cam}: {path}")
    else:
        print(write_raw_log(args.path, args.seed, args.scale))


if __name__ == "__main__":
    main()
