"""Devkit-free Argoverse-2 (sensor dataset) -> drivestudio-layout converter
(port of bilateral_driving_tpu/preprocess/argoverse.py; host-side numpy).

Reimplements the reference's av2-SensorDataloader-based processor
(reference `project/datasets/argoverse/argoverse_preprocess.py:42-571`)
directly against the raw AV2 log schema (feather tables via pandas):

    {root}/{log_id}/calibration/intrinsics.feather
    {root}/{log_id}/calibration/egovehicle_SE3_sensor.feather
    {root}/{log_id}/sensors/cameras/{cam}/{timestamp_ns}.jpg
    {root}/{log_id}/sensors/lidar/{timestamp_ns}.feather   x y z intensity
    {root}/{log_id}/city_SE3_egovehicle.feather
    {root}/{log_id}/annotations.feather

Semantics mirrored from the reference (cited lines):
  * frames are the 10 Hz LIDAR sweeps; each camera (20 Hz) contributes its
    nearest-timestamp image, and sweeps without a complete synchronized
    camera set (sequence edges) are dropped (`filter_lidar_indices`,
    argoverse_preprocess.py:128-156);
  * static cam-to-ego extrinsics + per-sweep ego pose (`save_calib`/
    `save_pose`, :236-260, :283-303; data/meta.py "ego_pose" style);
  * lidar: float32 (N, 4) [x y z intensity] already in the ego frame
    (`save_lidar`, :262-281); lidar_pose == ego pose for the generic
    loader;
  * objects: obj_to_world = city_SE3_ego(sweep_t) @ ego_SE3_object per
    annotation row, box_size [length width height], dense int re-keying
    (`save_objects`, :484-545);
  * dynamic masks: strict all-corners-projected check then axis-aligned
    bbox fill per class group (`save_dynamic_mask`, :414-482; class groups
    :26-38).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
from PIL import Image

AV2_NONRIGID_DYNAMIC_CLASSES = [
    "BICYCLIST", "DOG", "MOTORCYCLIST", "PEDESTRIAN", "STROLLER",
    "WHEELCHAIR", "WHEELED_DEVICE", "WHEELED_RIDER",
]
AV2_RIGID_DYNAMIC_CLASSES = [
    "ARTICULATED_BUS", "BOX_TRUCK", "BUS", "LARGE_VEHICLE",
    "MOTORCYCLE", "RAILED_VEHICLE", "REGULAR_VEHICLE", "SCHOOL_BUS",
    "TRUCK", "TRUCK_CAB", "VEHICULAR_TRAILER",
]
AV2_DYNAMIC_CLASSES = AV2_NONRIGID_DYNAMIC_CLASSES + AV2_RIGID_DYNAMIC_CLASSES

CAM_LIST = [
    "ring_front_center", "ring_front_left", "ring_front_right",
    "ring_side_left", "ring_side_right", "ring_rear_left",
    "ring_rear_right",
]
# max lidar<->camera timestamp gap for a sweep to count as synchronized
# (cameras run at 20 Hz -> nearest image is <= 25 ms away when present)
SYNC_TOL_NS = 50_000_000


def quat_xyzw_cols_to_mat(qw, qx, qy, qz, tx, ty, tz) -> np.ndarray:
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    w, x, y, z = qw / n, qx / n, qy / n, qz / n
    m = np.eye(4)
    m[:3, :3] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    m[:3, 3] = [tx, ty, tz]
    return m


def _row_mat(row) -> np.ndarray:
    return quat_xyzw_cols_to_mat(row["qw"], row["qx"], row["qy"], row["qz"],
                                 row["tx_m"], row["ty_m"], row["tz_m"])


class ArgoverseConverter:
    def __init__(self, data_root: str, target_dir: str,
                 process_keys=("images", "calib", "pose", "lidar",
                               "dynamic_masks", "objects")):
        self.root = data_root
        self.target = target_dir
        self.keys = set(process_keys)

    def convert_scene(self, log_id: str,
                      out_name: Optional[str] = None) -> str:
        import pandas as pd

        log = os.path.join(self.root, log_id)
        out = os.path.join(self.target, out_name or log_id)
        for sub in ("images", "extrinsics", "intrinsics", "sky_masks",
                    "ego_pose", "lidar", "lidar_pose", "dynamic_masks/all",
                    "dynamic_masks/human", "dynamic_masks/vehicle",
                    "instances"):
            os.makedirs(os.path.join(out, sub), exist_ok=True)

        intr = pd.read_feather(os.path.join(log, "calibration",
                                            "intrinsics.feather"))
        ext = pd.read_feather(os.path.join(log, "calibration",
                                           "egovehicle_SE3_sensor.feather"))
        poses = pd.read_feather(os.path.join(log,
                                             "city_SE3_egovehicle.feather"))
        pose_ts = poses["timestamp_ns"].to_numpy(np.int64)
        order = np.argsort(pose_ts)
        pose_ts = pose_ts[order]
        pose_rows = poses.iloc[order].reset_index(drop=True)

        def ego_pose_at(ts: int) -> Optional[np.ndarray]:
            i = int(np.searchsorted(pose_ts, ts))
            cand = [j for j in (i - 1, i) if 0 <= j < len(pose_ts)]
            if not cand:
                return None
            j = min(cand, key=lambda j: abs(int(pose_ts[j]) - ts))
            if abs(int(pose_ts[j]) - ts) > SYNC_TOL_NS:
                return None
            return _row_mat(pose_rows.iloc[j])

        cam_K, cam_ego, cam_ts, sizes = {}, {}, {}, {}
        for ci, cam in enumerate(CAM_LIST):
            row = intr[intr["sensor_name"] == cam].iloc[0]
            cam_K[ci] = np.array([row["fx_px"], row["fy_px"], row["cx_px"],
                                  row["cy_px"]])
            sizes[ci] = (int(row["width_px"]), int(row["height_px"]))
            erow = ext[ext["sensor_name"] == cam].iloc[0]
            cam_ego[ci] = _row_mat(erow)
            cdir = os.path.join(log, "sensors", "cameras", cam)
            cam_ts[ci] = np.sort(np.array(
                [int(f.split(".")[0]) for f in os.listdir(cdir)
                 if f.endswith(".jpg")], np.int64))

        lidar_dir = os.path.join(log, "sensors", "lidar")
        sweep_ts = sorted(int(f.split(".")[0]) for f in os.listdir(lidar_dir)
                          if f.endswith(".feather"))

        # synchronized frame list (argoverse_preprocess.py:128-156)
        frames = []
        for ts in sweep_ts:
            if ego_pose_at(ts) is None:
                continue
            picks = {}
            for ci in range(len(CAM_LIST)):
                t = cam_ts[ci]
                if t.size == 0:
                    break
                i = int(np.searchsorted(t, ts))
                cand = [j for j in (i - 1, i) if 0 <= j < t.size]
                j = min(cand, key=lambda j: abs(int(t[j]) - ts))
                if abs(int(t[j]) - ts) > SYNC_TOL_NS:
                    break
                picks[ci] = int(t[j])
            if len(picks) == len(CAM_LIST):
                frames.append((ts, picks))
        n_frames = len(frames)

        if "calib" in self.keys:
            for ci, cam in enumerate(CAM_LIST):
                np.savetxt(os.path.join(out, "extrinsics", f"{ci}.txt"),
                           cam_ego[ci])
                np.savetxt(os.path.join(out, "intrinsics", f"{ci}.txt"),
                           np.concatenate([cam_K[ci], np.zeros(5)]))

        ann = None
        if self.keys & {"objects", "dynamic_masks"}:
            ann = pd.read_feather(os.path.join(log, "annotations.feather"))

        info: Dict = {}
        per_frame = {}
        for fi, (ts, picks) in enumerate(frames):
            v2w = ego_pose_at(ts)
            if "pose" in self.keys or "calib" in self.keys:
                np.savetxt(os.path.join(out, "ego_pose", f"{fi:03d}.txt"),
                           v2w)
                np.savetxt(os.path.join(out, "lidar_pose", f"{fi:03d}.txt"),
                           v2w)
            if "images" in self.keys:
                for ci, cam in enumerate(CAM_LIST):
                    src = os.path.join(log, "sensors", "cameras", cam,
                                       f"{picks[ci]}.jpg")
                    Image.open(src).convert("RGB").save(
                        os.path.join(out, "images", f"{fi:03d}_{ci}.jpg"))
            if "lidar" in self.keys:
                sw = pd.read_feather(os.path.join(lidar_dir,
                                                  f"{ts}.feather"))
                rec = np.column_stack([sw["x"], sw["y"], sw["z"],
                                       sw["intensity"]])
                rec.astype(np.float32).tofile(
                    os.path.join(out, "lidar", f"{fi:03d}.bin"))

            if ann is None:
                continue
            rows = ann[ann["timestamp_ns"] == ts]
            per_frame[fi] = []
            for _, row in rows.iterrows():
                label = row["category"]
                if label not in AV2_DYNAMIC_CLASSES:
                    continue
                uid = row["track_uuid"]
                o2v = _row_mat(row)
                if "objects" in self.keys:
                    if uid not in info:
                        info[uid] = {
                            "id": uid, "class_name": label,
                            "frame_annotations": {
                                "frame_idx": [], "obj_to_world": [],
                                "box_size": []}}
                    rec = info[uid]["frame_annotations"]
                    rec["frame_idx"].append(fi)
                    rec["obj_to_world"].append((v2w @ o2v).tolist())
                    rec["box_size"].append([float(row["length_m"]),
                                            float(row["width_m"]),
                                            float(row["height_m"])])
                    per_frame[fi].append(uid)

            if "dynamic_masks" in self.keys:
                self._masks_for_frame(rows, fi, cam_K, cam_ego, sizes, out)

        if "objects" in self.keys:
            id_map = {v["id"]: i for i, v in enumerate(info.values())}
            new_info = {id_map[v["id"]]: v for v in info.values()}
            new_pf = {fi: [id_map[u] for u in us]
                      for fi, us in per_frame.items()}
            with open(os.path.join(out, "instances",
                                   "instances_info.json"), "w") as f:
                json.dump(new_info, f, indent=4)
            with open(os.path.join(out, "instances",
                                   "frame_instances.json"), "w") as f:
                json.dump(new_pf, f, indent=4)
        return out

    def _masks_for_frame(self, rows, fi, cam_K, cam_ego, sizes, out):
        groups = {"all": AV2_DYNAMIC_CLASSES,
                  "human": AV2_NONRIGID_DYNAMIC_CLASSES,
                  "vehicle": AV2_RIGID_DYNAMIC_CLASSES}
        for ci in range(len(CAM_LIST)):
            W, H = sizes[ci]
            K = cam_K[ci]
            e2c = np.linalg.inv(cam_ego[ci])
            masks = {g: np.zeros((H, W), np.uint8) for g in groups}
            for _, row in rows.iterrows():
                if row["category"] not in AV2_DYNAMIC_CLASSES:
                    continue
                l, w, h = row["length_m"], row["width_m"], row["height_m"]
                corners = np.array([[sx * l / 2, sy * w / 2, sz * h / 2]
                                    for sx in (-1, 1) for sy in (-1, 1)
                                    for sz in (-1, 1)])
                o2v = _row_mat(row)
                pts_e = corners @ o2v[:3, :3].T + o2v[:3, 3]
                cam = pts_e @ e2c[:3, :3].T + e2c[:3, 3]
                z = cam[:, 2]
                if (z <= 0).any():              # strict all-corner check
                    continue
                u = K[0] * cam[:, 0] / z + K[2]
                v = K[1] * cam[:, 1] / z + K[3]
                if not ((u >= 0).all() and (u < W).all()
                        and (v >= 0).all() and (v < H).all()):
                    continue
                ui = np.clip(u.astype(np.int32), 0, W - 1)
                vi = np.clip(v.astype(np.int32), 0, H - 1)
                if ui.max() == ui.min() or vi.max() == vi.min():
                    continue
                for g, classes in groups.items():
                    if row["category"] in classes:
                        masks[g][vi.min():vi.max(), ui.min():ui.max()] = 255
            for g in groups:
                Image.fromarray(masks[g], "L").save(os.path.join(
                    out, "dynamic_masks", g, f"{fi:03d}_{ci}.png"))
