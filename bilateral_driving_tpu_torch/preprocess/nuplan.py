"""Devkit-free nuPlan -> drivestudio-layout converter (port of
bilateral_driving_tpu/preprocess/nuplan.py; host-side numpy, as there).

Reimplements the reference's nuplan-devkit-based processor
(reference `project/datasets/nuplan/nuplan_preprocess.py:30-526`) by
reading the log's sqlite database directly (stdlib sqlite3; no nuplan ORM):

    {data_root}/{split}/{log_name}.db       tables: lidar_pc, image, camera,
                                            ego_pose, lidar_box, track,
                                            category
    {sensor_blobs}/{filename}               camera jpgs + lidar .pcd blobs

Semantics mirrored from the reference (cited lines):
  * lidar_pc runs at 20 Hz, cameras at 10 Hz: frames are every SECOND
    lidar_pc, with the start parity chosen by which aligns better with the
    camera timestamps (`convert_one`, nuplan_preprocess.py:118-155);
  * images: per frame, each channel's image row attached to the closest
    timestamp (`get_images_from_lidar_tokens` equivalent);
  * static cam-to-ego extrinsics from the camera table's rotation (wxyz
    quaternion) + translation; intrinsics [fx fy cx cy k1 k2 p1 p2 k3]
    carry nuPlan's real distortion (`save_calib`, :242-263 — the only
    dataset here with nonzero distortion, handled by the loader's
    undistort);
  * lidar: float32 (N, 6) [x y z intensity ring lidar_id] in the EGO frame
    (`save_lidar`, :264-279; loader reshape(-1, 6),
    nuplan_sourceloader.py:404);
  * ego pose per frame from the lidar_pc's ego_pose row;
  * objects: lidar_box rows (global/world frame, yaw about z) joined
    through track -> category for class names; box_size [length width
    height]; dense re-keying (`save_objects`);
  * dynamic masks: project the 8 world-frame corners through
    ego->cam, strict all-corners-visible check, bbox fill (:299-345).
"""
from __future__ import annotations

import json
import os
import sqlite3
from typing import Dict, Optional

import numpy as np
from PIL import Image

NUPLAN_NONRIGID_DYNAMIC_CLASSES = ["pedestrian", "bicycle"]
NUPLAN_RIGID_DYNAMIC_CLASSES = ["vehicle"]
NUPLAN_DYNAMIC_CLASSES = (NUPLAN_NONRIGID_DYNAMIC_CLASSES
                          + NUPLAN_RIGID_DYNAMIC_CLASSES)

CAM_LIST = ["CAM_F0", "CAM_L0", "CAM_R0", "CAM_L1", "CAM_R1", "CAM_L2",
            "CAM_R2", "CAM_B0"]


def _quat_wxyz_to_mat(q, t) -> np.ndarray:
    w, x, y, z = q
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    m = np.eye(4)
    m[:3, :3] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    m[:3, 3] = t
    return m


def _decode(field):
    """camera-table array fields: JSON text in the nuPlan db."""
    if isinstance(field, (bytes, bytearray)):
        field = field.decode()
    return np.asarray(json.loads(field), float)


def read_pcd(path: str) -> np.ndarray:
    """Minimal PCD reader for nuPlan MergedPointCloud blobs: ascii or
    binary data with float32 fields. Returns (N, n_fields)."""
    with open(path, "rb") as f:
        fields, size, count, n, fmt = [], [], [], 0, "binary"
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            key, _, rest = line.partition(" ")
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                size = [int(x) for x in rest.split()]
            elif key == "POINTS":
                n = int(rest)
            elif key == "DATA":
                fmt = rest.strip()
                break
        ncol = len(fields)
        if fmt == "ascii":
            rows = np.loadtxt(f, dtype=np.float32, ndmin=2)
            return rows.reshape(-1, ncol)[:n]
        assert all(s == 4 for s in size), "only 4-byte PCD fields supported"
        data = np.frombuffer(f.read(4 * ncol * n), np.float32)
        return data.reshape(n, ncol)


class NuplanConverter:
    def __init__(self, data_root: str, target_dir: str,
                 process_keys=("images", "calib", "pose", "lidar",
                               "dynamic_masks", "objects"),
                 split: str = "nuplan-v1.1/splits/mini",
                 sensor_blobs: Optional[str] = None,
                 start_frame_idx: int = 200, max_frames: int = 300):
        self.root = data_root
        self.split_dir = os.path.join(data_root, split)
        self.blobs = sensor_blobs or os.path.join(data_root,
                                                  "nuplan-v1.1",
                                                  "sensor_blobs")
        self.target = target_dir
        self.keys = set(process_keys)
        self.start = start_frame_idx
        self.max_frames = max_frames

    # ---------------------------------------------------------------- db
    def _db(self, log_name: str):
        con = sqlite3.connect(os.path.join(self.split_dir,
                                           f"{log_name}.db"))
        con.row_factory = sqlite3.Row
        return con

    @staticmethod
    def _images_for_lidar(con, lidar_ts: int) -> Dict[str, sqlite3.Row]:
        """Closest image per channel (get_images_from_lidar_tokens
        equivalent)."""
        out = {}
        for cam in con.execute("SELECT token, channel FROM camera"):
            row = con.execute(
                "SELECT i.*, ABS(i.timestamp - ?) AS dt FROM image i "
                "WHERE i.camera_token = ? ORDER BY dt LIMIT 1",
                (lidar_ts, cam["token"])).fetchone()
            if row is not None:
                out[cam["channel"]] = row
        return out

    def convert_scene(self, log_name: str,
                      out_name: Optional[str] = None) -> str:
        con = self._db(log_name)
        out = os.path.join(self.target, out_name or log_name)
        for sub in ("images", "extrinsics", "intrinsics", "sky_masks",
                    "ego_pose", "lidar", "dynamic_masks/all",
                    "dynamic_masks/human", "dynamic_masks/vehicle",
                    "instances"):
            os.makedirs(os.path.join(out, sub), exist_ok=True)

        pcs = con.execute(
            "SELECT * FROM lidar_pc ORDER BY timestamp").fetchall()
        start = min(self.start, max(len(pcs) - 2, 0))

        def sync_err(pc) -> float:
            imgs = self._images_for_lidar(con, pc["timestamp"])
            return sum(abs(i["timestamp"] - pc["timestamp"])
                       for i in imgs.values())

        # parity pick (nuplan_preprocess.py:131-155)
        if (len(pcs) > start + 1
                and sync_err(pcs[start]) > sync_err(pcs[start + 1])):
            start += 1
        frames = pcs[start::2][:self.max_frames]
        n_frames = len(frames)

        # calibration (camera table; wxyz rotation + translation = cam->ego)
        cams = {c["channel"]: c for c in con.execute("SELECT * FROM camera")}
        sizes = {}
        if "calib" in self.keys:
            for ci, ch in enumerate(CAM_LIST):
                if ch not in cams:
                    continue
                cam = cams[ch]
                c2e = _quat_wxyz_to_mat(_decode(cam["rotation"]),
                                        _decode(cam["translation"]))
                K = _decode(cam["intrinsic"]).reshape(3, 3)
                dist = _decode(cam["distortion"])
                np.savetxt(os.path.join(out, "extrinsics", f"{ci}.txt"),
                           c2e)
                np.savetxt(os.path.join(out, "intrinsics", f"{ci}.txt"),
                           np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                                     *dist[:5]]))

        info: Dict = {}
        per_frame = {}
        for fi, pc in enumerate(frames):
            ego = con.execute("SELECT * FROM ego_pose WHERE token = ?",
                              (pc["ego_pose_token"],)).fetchone()
            e2w = _quat_wxyz_to_mat(
                (ego["qw"], ego["qx"], ego["qy"], ego["qz"]),
                (ego["x"], ego["y"], ego["z"]))
            if "pose" in self.keys or "calib" in self.keys:
                np.savetxt(os.path.join(out, "ego_pose", f"{fi:03d}.txt"),
                           e2w)
            if "images" in self.keys:
                imgs = self._images_for_lidar(con, pc["timestamp"])
                for ci, ch in enumerate(CAM_LIST):
                    if ch not in imgs:
                        continue
                    src = os.path.join(self.blobs, imgs[ch]["filename_jpg"])
                    img = Image.open(src)
                    sizes[ci] = img.size
                    img.convert("RGB").save(
                        os.path.join(out, "images", f"{fi:03d}_{ci}.jpg"))
            if "lidar" in self.keys:
                pts = read_pcd(os.path.join(self.blobs, pc["filename"]))
                if pts.shape[1] < 6:     # v1 blobs: pad lidar_id column
                    pts = np.column_stack(
                        [pts, np.zeros((pts.shape[0],
                                        6 - pts.shape[1]), pts.dtype)])
                pts[:, :6].astype(np.float32).tofile(
                    os.path.join(out, "lidar", f"{fi:03d}.bin"))

            boxes = con.execute(
                "SELECT b.*, c.name AS category FROM lidar_box b "
                "JOIN track t ON b.track_token = t.token "
                "JOIN category c ON t.category_token = c.token "
                "WHERE b.lidar_pc_token = ?", (pc["token"],)).fetchall()
            per_frame[fi] = []
            for b in boxes:
                if b["category"] not in NUPLAN_DYNAMIC_CLASSES:
                    continue
                yaw = float(b["yaw"])
                c, s = np.cos(yaw), np.sin(yaw)
                o2w = np.array([
                    [c, -s, 0, b["x"]], [s, c, 0, b["y"]],
                    [0, 0, 1, b["z"]], [0, 0, 0, 1.0]])
                if "objects" in self.keys:
                    uid = b["track_token"]
                    if isinstance(uid, (bytes, bytearray)):
                        uid = uid.hex()
                    if uid not in info:
                        info[uid] = {
                            "id": uid, "class_name": b["category"],
                            "frame_annotations": {
                                "frame_idx": [], "obj_to_world": [],
                                "box_size": []}}
                    rec = info[uid]["frame_annotations"]
                    rec["frame_idx"].append(fi)
                    rec["obj_to_world"].append(o2w.tolist())
                    rec["box_size"].append([float(b["length"]),
                                            float(b["width"]),
                                            float(b["height"])])
                    per_frame[fi].append(uid)
            if "dynamic_masks" in self.keys:
                self._masks_for_frame(boxes, fi, cams, e2w, sizes, out)

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
        con.close()
        return out

    def _masks_for_frame(self, boxes, fi, cams, e2w, sizes, out):
        groups = {"all": NUPLAN_DYNAMIC_CLASSES,
                  "human": NUPLAN_NONRIGID_DYNAMIC_CLASSES,
                  "vehicle": NUPLAN_RIGID_DYNAMIC_CLASSES}
        w2e = np.linalg.inv(e2w)
        for ci, ch in enumerate(CAM_LIST):
            if ch not in cams:
                continue
            cam = cams[ch]
            W, H = sizes.get(ci, (1920, 1080))
            c2e = _quat_wxyz_to_mat(_decode(cam["rotation"]),
                                    _decode(cam["translation"]))
            e2c = np.linalg.inv(c2e)
            K = _decode(cam["intrinsic"]).reshape(3, 3)
            masks = {g: np.zeros((H, W), np.uint8) for g in groups}
            for b in boxes:
                if b["category"] not in NUPLAN_DYNAMIC_CLASSES:
                    continue
                l, w, h = b["length"], b["width"], b["height"]
                yaw = float(b["yaw"])
                c, s = np.cos(yaw), np.sin(yaw)
                R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                corners = np.array([[sx * l / 2, sy * w / 2, sz * h / 2]
                                    for sx in (-1, 1) for sy in (-1, 1)
                                    for sz in (-1, 1)])
                pts_w = corners @ R.T + np.array([b["x"], b["y"], b["z"]])
                pts_c = ((pts_w @ w2e[:3, :3].T + w2e[:3, 3])
                         @ e2c[:3, :3].T + e2c[:3, 3])
                z = pts_c[:, 2]
                if (z <= 0).any():
                    continue
                u = K[0, 0] * pts_c[:, 0] / z + K[0, 2]
                v = K[1, 1] * pts_c[:, 1] / z + K[1, 2]
                if not ((u >= 0).all() and (u < W).all()
                        and (v >= 0).all() and (v < H).all()):
                    continue
                ui = np.clip(u.astype(np.int32), 0, W - 1)
                vi = np.clip(v.astype(np.int32), 0, H - 1)
                if ui.max() == ui.min() or vi.max() == vi.min():
                    continue
                for g, classes in groups.items():
                    if b["category"] in classes:
                        masks[g][vi.min():vi.max(), ui.min():ui.max()] = 255
            for g in groups:
                Image.fromarray(masks[g], "L").save(os.path.join(
                    out, "dynamic_masks", g, f"{fi:03d}_{ci}.png"))
