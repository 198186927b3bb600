"""Devkit-free KITTI-raw -> drivestudio-layout converter (port of
bilateral_driving_tpu/preprocess/kitti.py; host-side numpy, as there).

Reimplements the reference's pykitti-based processor
(reference `project/datasets/kitti/kitti_preprocess.py:29-411`) from
the raw on-disk schema directly (no pykitti):

  * calibration (`save_calib`, kitti_preprocess.py:128-151): rectified
    K_cam2/K_cam3 and T_camN_velo from calib_cam_to_cam.txt /
    calib_velo_to_cam.txt via the standard rectification chain
    T_camN_velo = Tshift(P_rect_N0) @ R_rect_00 @ [R|T]_velo_to_cam;
    extrinsics/{cam}.txt stores the inverse (cam-to-ego, ego == velodyne);
  * ego poses (`save_pose`, :153-162): OxTS lat/lon/alt/rpy -> Mercator
    translation (origin at the first frame) x Rz(yaw)Ry(pitch)Rx(roll),
    composed with T_velo_imu from calib_imu_to_velo.txt;
  * lidar (`save_lidar`, :164-171): velodyne float32 (N, 4) xyzi copied
    verbatim (already in the ego frame); lidar_pose/{t}.txt == ego pose so
    the generic loader (data/scene.py) places points correctly;
  * tracklets (trackletparser.py equivalents): tracklet_labels.xml parsed
    with ElementTree; boxes annotated at the bottom center with size
    (h, w, l) and yaw about velodyne z (kitti_preprocess.py:198-216);
  * objects (`save_objects`, :265-332): obj_to_world = velo2world @ o2v with
    tz += h/2 and box_size emitted as [l, w, h]; ids renumbered densely;
  * dynamic masks (`save_dynamic_mask`, :173-263): KITTI uses the STRICT
    all-corners-visible check and fills the axis-aligned bounding box of the
    projected corners (unlike nuScenes' convex hull), per class group
    all/human/vehicle (KITTI_*_DYNAMIC_CLASSES, :15-27).

Raw layout expected under data_root:
    {date}/calib_cam_to_cam.txt, calib_velo_to_cam.txt, calib_imu_to_velo.txt
    {date}/{date}_drive_{dddd}_sync/image_02/data/{f:010d}.png   (CAM_LEFT)
    {date}/{date}_drive_{dddd}_sync/image_03/data/{f:010d}.png   (CAM_RIGHT)
    {date}/{date}_drive_{dddd}_sync/velodyne_points/data/{f:010d}.bin
    {date}/{date}_drive_{dddd}_sync/oxts/data/{f:010d}.txt
    {date}/{date}_drive_{dddd}_sync/tracklet_labels.xml
"""
from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

KITTI_NONRIGID_DYNAMIC_CLASSES = ["Pedestrian", "Person_sitting", "Cyclist"]
KITTI_RIGID_DYNAMIC_CLASSES = ["Car", "Van", "Truck", "Tram"]
KITTI_DYNAMIC_CLASSES = (KITTI_NONRIGID_DYNAMIC_CLASSES
                         + KITTI_RIGID_DYNAMIC_CLASSES)

ER = 6378137.0          # WGS-84 equatorial radius (OxTS Mercator)


# ---------------------------------------------------------------------------
# raw-schema readers
# ---------------------------------------------------------------------------


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            try:
                out[k.strip()] = np.array(
                    [float(x) for x in v.strip().split()])
            except ValueError:
                pass                      # calib_time etc.
    return out


def _rt(R9, T3) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = np.asarray(R9, float).reshape(3, 3)
    m[:3, 3] = np.asarray(T3, float)
    return m


def load_calib(date_dir: str) -> Dict[str, np.ndarray]:
    """Rectified intrinsics + velo/imu chains (pykitti raw-calib math)."""
    c2c = read_calib_file(os.path.join(date_dir, "calib_cam_to_cam.txt"))
    v2c = read_calib_file(os.path.join(date_dir, "calib_velo_to_cam.txt"))
    i2v = read_calib_file(os.path.join(date_dir, "calib_imu_to_velo.txt"))
    T_cam0_velo = _rt(v2c["R"], v2c["T"])
    R_rect = np.eye(4)
    R_rect[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
    out = {"T_velo_imu": _rt(i2v["R"], i2v["T"])}
    for cam, idx in (("cam2", 2), ("cam3", 3)):
        P = c2c[f"P_rect_0{idx}"].reshape(3, 4)
        Tshift = np.eye(4)
        Tshift[0, 3] = P[0, 3] / P[0, 0]
        out[f"T_{cam}_velo"] = Tshift @ R_rect @ T_cam0_velo
        out[f"K_{cam}"] = P[:3, :3].copy()
    return out


def oxts_pose(lines: List[np.ndarray]) -> np.ndarray:
    """(F, 4, 4) T_w_imu from raw OxTS packets: Mercator translation with the
    first frame as origin, Rz(yaw) Ry(pitch) Rx(roll) orientation."""
    lat0 = lines[0][0]
    scale = np.cos(lat0 * np.pi / 180.0)
    poses, origin = [], None
    for v in lines:
        lat, lon, alt, roll, pitch, yaw = v[:6]
        tx = scale * lon * np.pi * ER / 180.0
        ty = scale * ER * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
        t = np.array([tx, ty, alt])
        if origin is None:
            origin = t.copy()
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        m = np.eye(4)
        m[:3, :3] = Rz @ Ry @ Rx
        m[:3, 3] = t - origin
        poses.append(m)
    return np.stack(poses)


def parse_tracklets(xml_path: str) -> List[dict]:
    """tracklet_labels.xml -> [{type, size(h,w,l), first_frame, trans(M,3),
    rots(M,3)}] (reference trackletparser.parseXML equivalents)."""
    root = ET.parse(xml_path).getroot()
    tracklets = []
    container = root.find("tracklets")
    if container is None:
        return tracklets
    for item in container.findall("item"):
        size = [float(item.find(k).text) for k in ("h", "w", "l")]
        first = int(item.find("first_frame").text)
        trans, rots = [], []
        for pose in item.find("poses").findall("item"):
            trans.append([float(pose.find(k).text) for k in ("tx", "ty",
                                                             "tz")])
            rots.append([float(pose.find(k).text) for k in ("rx", "ry",
                                                            "rz")])
        tracklets.append({
            "type": item.find("objectType").text,
            "size": size,                       # (h, w, l)
            "first_frame": first,
            "trans": np.array(trans),
            "rots": np.array(rots),
        })
    return tracklets


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------


def _obj_to_velo(t_obj, rz, h) -> np.ndarray:
    """Bottom-center annotation -> centered box pose in the velodyne frame
    (kitti_preprocess.py:198-216: tz += h/2, yaw about velo z)."""
    c, s = np.cos(rz), np.sin(rz)
    tx, ty, tz = t_obj
    return np.array([
        [c, -s, 0, tx],
        [s, c, 0, ty],
        [0, 0, 1, tz + h / 2.0],
        [0, 0, 0, 1.0],
    ])


def _project_corners(corners_velo, T_cam_velo, K):
    cam = corners_velo @ T_cam_velo[:3, :3].T + T_cam_velo[:3, 3]
    z = np.maximum(cam[:, 2], 1e-6)
    u = K[0, 0] * cam[:, 0] / z + K[0, 2]
    v = K[1, 1] * cam[:, 1] / z + K[1, 2]
    return u, v, cam[:, 2]


def _box_corners_local(l, w, h) -> np.ndarray:
    """(8, 3) corners of an l x w x h box centered at the origin."""
    return np.array([[sx * l / 2, sy * w / 2, sz * h / 2]
                     for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])


class KittiConverter:
    CAMERAS = {0: "image_02", 1: "image_03"}     # CAM_LEFT, CAM_RIGHT

    def __init__(self, data_root: str, target_dir: str,
                 process_keys=("images", "calib", "pose", "lidar",
                               "dynamic_masks", "objects")):
        self.root = data_root
        self.target = target_dir
        self.keys = set(process_keys)

    def _drive_dir(self, scene_name: str) -> str:
        date = scene_name.rsplit("_drive_", 1)[0]
        return os.path.join(self.root, date, scene_name)

    def convert_scene(self, scene_name: str,
                      out_name: Optional[str] = None) -> str:
        """scene_name like '2011_09_26_drive_0001_sync'."""
        date = scene_name.rsplit("_drive_", 1)[0]
        drive = self._drive_dir(scene_name)
        calib = load_calib(os.path.join(self.root, date))
        out = os.path.join(self.target, out_name or scene_name)
        for sub in ("images", "extrinsics", "intrinsics", "sky_masks",
                    "ego_pose", "lidar", "lidar_pose",
                    "dynamic_masks/all", "dynamic_masks/human",
                    "dynamic_masks/vehicle", "instances"):
            os.makedirs(os.path.join(out, sub), exist_ok=True)

        oxts_dir = os.path.join(drive, "oxts", "data")
        frames = sorted(os.listdir(oxts_dir))
        packets = [np.loadtxt(os.path.join(oxts_dir, f)) for f in frames]
        T_w_imu = oxts_pose(packets)
        # ego == velodyne (kitti_preprocess.py:129,154)
        velo2world = T_w_imu @ calib["T_velo_imu"]
        n_frames = len(frames)

        if "calib" in self.keys:
            for ci, cam in ((0, "cam2"), (1, "cam3")):
                np.savetxt(os.path.join(out, "extrinsics", f"{ci}.txt"),
                           np.linalg.inv(calib[f"T_{cam}_velo"]))
                Kc = calib[f"K_{cam}"]
                # fx, fy, cx, cy, p1, p2, k1, k2, k3 (rectified: zero dist)
                np.savetxt(os.path.join(out, "intrinsics", f"{ci}.txt"),
                           np.array([Kc[0, 0], Kc[1, 1], Kc[0, 2], Kc[1, 2],
                                     0, 0, 0, 0, 0]))
        if "pose" in self.keys or "calib" in self.keys:
            for t in range(n_frames):
                np.savetxt(os.path.join(out, "ego_pose", f"{t:03d}.txt"),
                           velo2world[t])
                np.savetxt(os.path.join(out, "lidar_pose", f"{t:03d}.txt"),
                           velo2world[t])

        sizes = {}
        if "images" in self.keys:
            for t in range(n_frames):
                for ci, imdir in self.CAMERAS.items():
                    src = os.path.join(drive, imdir, "data",
                                       f"{t:010d}.png")
                    img = Image.open(src)
                    sizes[ci] = img.size
                    img.convert("RGB").save(
                        os.path.join(out, "images", f"{t:03d}_{ci}.jpg"))

        if "lidar" in self.keys:
            vdir = os.path.join(drive, "velodyne_points", "data")
            for t in range(n_frames):
                pts = np.fromfile(os.path.join(vdir, f"{t:010d}.bin"),
                                  dtype=np.float32).reshape(-1, 4)
                pts.tofile(os.path.join(out, "lidar", f"{t:03d}.bin"))

        tr_file = os.path.join(drive, "tracklet_labels.xml")
        tracklets = parse_tracklets(tr_file) if os.path.exists(tr_file) \
            else []

        if "objects" in self.keys:
            info, per_frame = self._build_objects(tracklets, velo2world,
                                                  n_frames)
            with open(os.path.join(out, "instances",
                                   "instances_info.json"), "w") as f:
                json.dump(info, f, indent=4)
            with open(os.path.join(out, "instances",
                                   "frame_instances.json"), "w") as f:
                json.dump(per_frame, f, indent=4)

        if "dynamic_masks" in self.keys:
            self._save_dynamic_masks(tracklets, calib, n_frames, sizes, out)
        return out

    def _build_objects(self, tracklets, velo2world, n_frames):
        """kitti_preprocess.py:265-332: dynamic classes only, obj_to_world
        through the per-frame ego pose, box_size as [l, w, h]."""
        info, per_frame = {}, {f: [] for f in range(n_frames)}
        nid = 0
        for tr in tracklets:
            if tr["type"] not in KITTI_DYNAMIC_CLASSES:
                continue
            h, w, l = tr["size"]
            rec = {"id": nid, "class_name": tr["type"],
                   "frame_annotations": {"frame_idx": [], "obj_to_world": [],
                                         "box_size": []}}
            for step in range(tr["trans"].shape[0]):
                fi = tr["first_frame"] + step
                if fi >= n_frames:
                    break
                o2v = _obj_to_velo(tr["trans"][step], tr["rots"][step][2], h)
                o2w = velo2world[fi] @ o2v
                rec["frame_annotations"]["frame_idx"].append(fi)
                rec["frame_annotations"]["obj_to_world"].append(o2w.tolist())
                rec["frame_annotations"]["box_size"].append([l, w, h])
                per_frame[fi].append(nid)
            info[nid] = rec
            nid += 1
        return info, per_frame

    def _save_dynamic_masks(self, tracklets, calib, n_frames, sizes, out):
        """kitti_preprocess.py:173-263: strict all-corners-visible check,
        axis-aligned bbox fill, per class group."""
        groups = {"all": KITTI_DYNAMIC_CLASSES,
                  "human": KITTI_NONRIGID_DYNAMIC_CLASSES,
                  "vehicle": KITTI_RIGID_DYNAMIC_CLASSES}
        for t in range(n_frames):
            for ci, cam in ((0, "cam2"), (1, "cam3")):
                W, H = sizes.get(ci, (1242, 375))
                masks = {g: np.zeros((H, W), np.uint8) for g in groups}
                for tr in tracklets:
                    step = t - tr["first_frame"]
                    if step < 0 or step >= tr["trans"].shape[0]:
                        continue
                    if tr["type"] not in KITTI_DYNAMIC_CLASSES:
                        continue
                    h, w, l = tr["size"]
                    o2v = _obj_to_velo(tr["trans"][step],
                                       tr["rots"][step][2], h)
                    corners = (_box_corners_local(l, w, h) @ o2v[:3, :3].T
                               + o2v[:3, 3])
                    u, v, _ = _project_corners(corners,
                                               calib[f"T_{cam}_velo"],
                                               calib[f"K_{cam}"])
                    # strict: every corner inside the image (:229-234)
                    if not ((u >= 0).all() and (u < W).all()
                            and (v >= 0).all() and (v < H).all()):
                        continue
                    ui = np.clip(u.astype(np.int32), 0, W - 1)
                    vi = np.clip(v.astype(np.int32), 0, H - 1)
                    if ui.max() == ui.min() or vi.max() == vi.min():
                        continue
                    for g, classes in groups.items():
                        if tr["type"] in classes:
                            masks[g][vi.min():vi.max(),
                                     ui.min():ui.max()] = 255
                for g in groups:
                    Image.fromarray(masks[g], "L").save(os.path.join(
                        out, "dynamic_masks", g, f"{t:03d}_{ci}.png"))
