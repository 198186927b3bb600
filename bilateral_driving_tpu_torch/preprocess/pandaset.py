"""Devkit-free PandaSet -> drivestudio-layout converter (port of
bilateral_driving_tpu/preprocess/pandaset.py; host-side numpy, as there).

Reimplements the reference's pandaset-devkit-based processor
(reference `project/datasets/pandaset/pandaset_preprocess.py:37-603`)
against the raw sequence schema directly:

    {root}/{seq}/camera/{cam}/{f:02d}.jpg
    {root}/{seq}/camera/{cam}/poses.json       [{position, heading(wxyz)}]
    {root}/{seq}/camera/{cam}/intrinsics.json  {fx, fy, cx, cy}
    {root}/{seq}/lidar/{f:02d}.pkl.gz          pandas DF x y z i t d
    {root}/{seq}/lidar/poses.json
    {root}/{seq}/annotations/cuboids/{f:02d}.pkl.gz

Semantics mirrored from the reference (cited lines):
  * per-frame cam-to-world extrinsics + static intrinsics (`save_calib`,
    pandaset_preprocess.py:223-247; data/meta.py "per_frame" style);
  * ego pose := the mechanical lidar pose (`save_pose`, :287-304 — PandaSet
    ships no ego pose);
  * lidar: world points re-expressed in the lidar/ego frame, stored as
    float32 (N, 5) [x y z intensity laser_id] (`save_lidar`, :249-285;
    reference loader reshape(-1, 5), pandaset_sourceloader.py:409);
  * cuboids are annotated directly in WORLD frame with yaw about +z
    (`save_objects`, :522-576): obj_to_world = Rz(yaw)|position, box_size =
    [dim_x(len), dim_y(width), dim_z(height)];
  * sibling dedup across the two lidars (keep the longer track, :128-152)
    and removal of always-stationary objects (:154-163);
  * dynamic masks: strict all-8-corners-projected check then axis-aligned
    bbox fill, per class group (`save_dynamic_mask`, :432-520; class groups
    :14-35).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
from PIL import Image

PANDA_NONRIGID_DYNAMIC_CLASSES = [
    "Pedestrian", "Pedestrian with Object", "Bicycle", "Animals - Other",
]
PANDA_RIGID_DYNAMIC_CLASSES = [
    "Bus", "Car", "Emergency Vehicle", "Medium-sized Truck",
    "Motorcycle", "Motorized Scooter",
    "Other Vehicle - Construction Vehicle", "Other Vehicle - Pedicab",
    "Other Vehicle - Uncommon", "Personal Mobility Device", "Pickup Truck",
    "Semi-truck", "Train", "Tram / Subway",
]
PANDA_DYNAMIC_CLASSES = (PANDA_NONRIGID_DYNAMIC_CLASSES
                         + PANDA_RIGID_DYNAMIC_CLASSES)

CAM_LIST = [
    "front_camera", "front_left_camera", "front_right_camera",
    "left_camera", "right_camera", "back_camera",
]


def heading_position_to_mat(heading: dict, position: dict) -> np.ndarray:
    """pandaset geometry._heading_position_to_mat: wxyz quat + position."""
    w, x, y, z = (heading["w"], heading["x"], heading["y"], heading["z"])
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    m = np.eye(4)
    m[:3, :3] = R
    m[:3, 3] = [position["x"], position["y"], position["z"]]
    return m


def center_box_to_corners(box) -> np.ndarray:
    """pandaset geometry.center_box_to_corners: world-frame cuboid
    [x y z dx dy dz yaw(z)] -> (8, 3) corners."""
    x, y, z, dx, dy, dz, yaw = box
    local = np.array([[sx * dx / 2, sy * dy / 2, sz * dz / 2]
                      for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)])
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return local @ R.T + np.array([x, y, z])


def project_world_points(pts_w, c2w, K, width, height):
    """pandaset geometry.projection with filter_outliers semantics: returns
    only the in-image, in-front projections."""
    w2c = np.linalg.inv(c2w)
    cam = pts_w @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    u = K[0] * cam[:, 0] / np.maximum(z, 1e-9) + K[2]
    v = K[1] * cam[:, 1] / np.maximum(z, 1e-9) + K[3]
    ok = (z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return np.stack([u[ok], v[ok]], axis=1)


def _read_df(path: str):
    import pandas as pd
    return pd.read_pickle(path)


class PandasetConverter:
    def __init__(self, data_root: str, target_dir: str,
                 process_keys=("images", "calib", "pose", "lidar",
                               "dynamic_masks", "objects")):
        self.root = data_root
        self.target = target_dir
        self.keys = set(process_keys)

    def convert_scene(self, seq: str, out_name: Optional[str] = None) -> str:
        seq_dir = os.path.join(self.root, seq)
        out = os.path.join(self.target, out_name or seq)
        for sub in ("images", "extrinsics", "intrinsics", "sky_masks",
                    "ego_pose", "lidar", "dynamic_masks/all",
                    "dynamic_masks/human", "dynamic_masks/vehicle",
                    "instances"):
            os.makedirs(os.path.join(out, sub), exist_ok=True)

        lidar_poses = json.load(open(os.path.join(seq_dir, "lidar",
                                                  "poses.json")))
        n_frames = len(lidar_poses)
        cam_poses, cam_K, sizes = {}, {}, {}
        for ci, cam in enumerate(CAM_LIST):
            cdir = os.path.join(seq_dir, "camera", cam)
            cam_poses[ci] = json.load(open(os.path.join(cdir, "poses.json")))
            K = json.load(open(os.path.join(cdir, "intrinsics.json")))
            cam_K[ci] = np.array([K["fx"], K["fy"], K["cx"], K["cy"]])

        if "calib" in self.keys:
            for ci, cam in enumerate(CAM_LIST):
                np.savetxt(os.path.join(out, "intrinsics", f"{ci}.txt"),
                           np.concatenate([cam_K[ci], np.zeros(5)]))
                for t in range(n_frames):
                    c2w = heading_position_to_mat(
                        cam_poses[ci][t]["heading"],
                        cam_poses[ci][t]["position"])
                    np.savetxt(os.path.join(out, "extrinsics",
                                            f"{t:03d}_{ci}.txt"), c2w)

        if "pose" in self.keys or "calib" in self.keys:
            for t in range(n_frames):
                l2w = heading_position_to_mat(lidar_poses[t]["heading"],
                                              lidar_poses[t]["position"])
                np.savetxt(os.path.join(out, "ego_pose", f"{t:03d}.txt"),
                           l2w)

        if "images" in self.keys:
            for t in range(n_frames):
                for ci, cam in enumerate(CAM_LIST):
                    src = os.path.join(seq_dir, "camera", cam,
                                       f"{t:02d}.jpg")
                    img = Image.open(src)
                    sizes[ci] = img.size
                    img.convert("RGB").save(
                        os.path.join(out, "images", f"{t:03d}_{ci}.jpg"))

        if "lidar" in self.keys:
            for t in range(n_frames):
                df = _read_df(os.path.join(seq_dir, "lidar",
                                           f"{t:02d}.pkl.gz"))
                pts_w = df[["x", "y", "z"]].to_numpy(float)
                l2w = heading_position_to_mat(lidar_poses[t]["heading"],
                                              lidar_poses[t]["position"])
                w2l = np.linalg.inv(l2w)
                pts_ego = pts_w @ w2l[:3, :3].T + w2l[:3, 3]
                rec = np.column_stack([pts_ego, df["i"].to_numpy(float),
                                       df["d"].to_numpy(float)])
                rec.astype(np.float32).tofile(
                    os.path.join(out, "lidar", f"{t:03d}.bin"))

        cuboids = None
        if self.keys & {"objects", "dynamic_masks"}:
            cuboids = [
                _read_df(os.path.join(seq_dir, "annotations", "cuboids",
                                      f"{t:02d}.pkl.gz"))
                for t in range(n_frames)
            ]

        if "objects" in self.keys:
            info, per_frame = self._build_objects(cuboids, n_frames)
            with open(os.path.join(out, "instances",
                                   "instances_info.json"), "w") as f:
                json.dump(info, f, indent=4)
            with open(os.path.join(out, "instances",
                                   "frame_instances.json"), "w") as f:
                json.dump(per_frame, f, indent=4)

        if "dynamic_masks" in self.keys:
            self._save_dynamic_masks(cuboids, cam_poses, cam_K, sizes,
                                     n_frames, out)
        return out

    @staticmethod
    def _dedup_iter(df):
        """Row iterator with the reference's sibling skip within one frame
        (pandaset_preprocess.py:464-471): a cuboid seen by a single lidar is
        skipped when its sibling was already recorded."""
        recorded = set()
        for _, row in df.iterrows():
            if int(row.get("cuboids.sensor_id", -1)) != -1:
                if row.get("cuboids.sibling_id", "-") in recorded:
                    continue
            recorded.add(row["uuid"])
            yield row

    def _build_objects(self, cuboids, n_frames):
        """pandaset_preprocess.py:522-576 + the cross-lidar sibling dedup
        (:128-152) and always-stationary filter (:154-163)."""
        info = {}
        for t in range(n_frames):
            for _, row in cuboids[t].iterrows():
                uid, label = row["uuid"], row["label"]
                if label not in PANDA_DYNAMIC_CLASSES:
                    continue
                if uid not in info:
                    info[uid] = {
                        "id": uid, "class_name": label,
                        "sibling_id": row.get("cuboids.sibling_id", "-"),
                        "frame_annotations": {
                            "frame_idx": [], "obj_to_world": [],
                            "box_size": [], "stationary": []},
                    }
                yaw = float(row["yaw"])
                c, s = np.cos(yaw), np.sin(yaw)
                o2w = np.array([
                    [c, -s, 0, row["position.x"]],
                    [s, c, 0, row["position.y"]],
                    [0, 0, 1, row["position.z"]],
                    [0, 0, 0, 1.0]])
                ann = info[uid]["frame_annotations"]
                ann["frame_idx"].append(t)
                ann["obj_to_world"].append(o2w.tolist())
                ann["box_size"].append([float(row["dimensions.x"]),
                                        float(row["dimensions.y"]),
                                        float(row["dimensions.z"])])
                ann["stationary"].append(bool(row["stationary"]))

        # sibling dedup: keep the longer track of each pair
        pairs = []
        for v in info.values():
            sib = v["sibling_id"]
            if sib and sib != "-" and (sib, v["id"]) not in pairs:
                pairs.append((v["id"], sib))
        for a, b in pairs:
            if a in info and b in info:
                drop = b if (len(info[a]["frame_annotations"]["frame_idx"])
                             > len(info[b]["frame_annotations"]["frame_idx"])
                             ) else a
                info.pop(drop)
        # drop always-stationary objects
        for uid in [k for k, v in info.items()
                    if all(v["frame_annotations"]["stationary"])]:
            info.pop(uid)

        # dense integer re-keying (reference :182-193)
        id_map = {v["id"]: i for i, v in enumerate(info.values())}
        new_info = {id_map[v["id"]]: v for v in info.values()}
        per_frame = {t: [id_map[v["id"]] for v in info.values()
                         if t in v["frame_annotations"]["frame_idx"]]
                     for t in range(n_frames)}
        return new_info, per_frame

    def _save_dynamic_masks(self, cuboids, cam_poses, cam_K, sizes,
                            n_frames, out):
        groups = {"all": PANDA_DYNAMIC_CLASSES,
                  "human": PANDA_NONRIGID_DYNAMIC_CLASSES,
                  "vehicle": PANDA_RIGID_DYNAMIC_CLASSES}
        for t in range(n_frames):
            for ci in range(len(CAM_LIST)):
                W, H = sizes.get(ci, (1920, 1080))
                c2w = heading_position_to_mat(cam_poses[ci][t]["heading"],
                                              cam_poses[ci][t]["position"])
                masks = {g: np.zeros((H, W), np.uint8) for g in groups}
                for row in self._dedup_iter(cuboids[t]):
                    if (row["label"] not in PANDA_DYNAMIC_CLASSES
                            or bool(row["stationary"])):
                        continue
                    corners = center_box_to_corners([
                        row["position.x"], row["position.y"],
                        row["position.z"], row["dimensions.x"],
                        row["dimensions.y"], row["dimensions.z"],
                        row["yaw"]])
                    uv = project_world_points(corners, c2w, cam_K[ci], W, H)
                    if uv.shape[0] != 8:      # strict: every corner visible
                        continue
                    u = np.clip(uv[:, 0].astype(np.int32), 0, W)
                    v = np.clip(uv[:, 1].astype(np.int32), 0, H)
                    if u.max() == u.min() or v.max() == v.min():
                        continue
                    for g, classes in groups.items():
                        if row["label"] in classes:
                            masks[g][v.min():v.max(), u.min():u.max()] = 255
                for g in groups:
                    Image.fromarray(masks[g], "L").save(os.path.join(
                        out, "dynamic_masks", g, f"{t:03d}_{ci}.png"))
