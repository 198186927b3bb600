"""Raw nuScenes -> drivestudio-layout converter (port of
bilateral_driving_tpu/preprocess/nuscenes.py).

Counterpart of the reference's `NuScenesProcessor`
(project/datasets/nuscenes/nuscenes_preprocess.py:72-1084) with the same
output contract — the processed directory that data/scene.py (and the
reference's own sourceloaders) consume:

    images/{t:03d}_{cam}.jpg      extrinsics/{t:03d}_{cam}.txt
    intrinsics/{cam}.txt          lidar/{t:03d}.bin   lidar_pose/{t:03d}.txt
    dynamic_masks/{all,human,vehicle}/{t:03d}_{cam}.png
    instances/{instances_info,frame_instances}.json

Unlike the reference it does NOT require the nuscenes-devkit: the raw
v1.0-* table JSONs are joined directly with numpy, so the converter runs in
any environment that has the raw data on disk. Semantics follow the
reference's *interpolated* mode (docs/NuScenes.md:46-53): keyframes are 2 Hz,
boxes/poses are lifted to 10 Hz by interpolating between keyframes and
pairing each target timestamp with the closest camera sweep / lidar sweep.

Sky masks come from the SegFormer tool (preprocess/masks.py), SMPL tracking
from an external 4D-Humans pipeline — both separate stages, as in the
reference (datasets/tools/extract_masks.py, extract_smpl.py).

Table joins, interpolation, the 8-corner box projection, the rounding to
1e-3 px and the monotone-chain hull run on the host in float64 numpy, as
in the JAX package. The dynamic masks are filled on `device` (default
cuda): every hull of one (frame, camera) in one batched pass
(`fill_convex`), which forms the JAX package's half-plane test op by op
in float64 (one eager PyTorch op each, nothing fused or contracted into
an FMA), so the masks are bit-equal to its `_fill_convex`.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List

import numpy as np
import torch

CAMERAS = ["CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
           "CAM_BACK_LEFT", "CAM_BACK_RIGHT", "CAM_BACK"]
LIDAR = "LIDAR_TOP"
HZ_FACTOR = 5                   # 2 Hz keyframes -> 10 Hz targets

# nuScenes category prefixes -> mask class (save_dynamic_mask class_valid)
HUMAN_PREFIXES = ("human.pedestrian",)
VEHICLE_PREFIXES = ("vehicle.car", "vehicle.truck", "vehicle.bus",
                    "vehicle.trailer", "vehicle.construction",
                    "vehicle.emergency")
DYNAMIC_PREFIXES = HUMAN_PREFIXES + VEHICLE_PREFIXES + (
    "vehicle.motorcycle", "vehicle.bicycle")


# --------------------------------------------------------------------------
# raw table access (devkit-free)
# --------------------------------------------------------------------------


class Tables:
    """The raw nuScenes relational tables, indexed by token."""

    NAMES = ["scene", "sample", "sample_data", "ego_pose",
             "calibrated_sensor", "sensor", "sample_annotation", "instance",
             "category"]

    def __init__(self, data_root: str, version: str = "v1.0-mini"):
        self.data_root = data_root
        base = os.path.join(data_root, version)
        self.by_token: Dict[str, Dict[str, dict]] = {}
        self.rows: Dict[str, List[dict]] = {}
        for name in self.NAMES:
            with open(os.path.join(base, f"{name}.json")) as f:
                rows = json.load(f)
            self.rows[name] = rows
            self.by_token[name] = {r["token"]: r for r in rows}

    def get(self, table: str, token: str) -> dict:
        return self.by_token[table][token]

    def scene_samples(self, scene: dict) -> List[dict]:
        """Ordered keyframe samples of a scene."""
        out = []
        tok = scene["first_sample_token"]
        while tok:
            s = self.get("sample", tok)
            out.append(s)
            tok = s["next"]
        return out

    def channel_sample_datas(self, scene: dict, channel: str) -> List[dict]:
        """Every sample_data (keyframes + sweeps) of one sensor channel in a
        scene, time-ordered."""
        sample_tokens = {s["token"] for s in self.scene_samples(scene)}
        out = []
        for sd in self.rows["sample_data"]:
            if sd["sample_token"] not in sample_tokens:
                continue
            sensor = self.get(
                "sensor",
                self.get("calibrated_sensor",
                         sd["calibrated_sensor_token"])["sensor_token"])
            if sensor["channel"] == channel:
                out.append(sd)
        out.sort(key=lambda r: r["timestamp"])
        return out


def _quat_to_mat(q_wxyz) -> np.ndarray:
    w, x, y, z = [float(v) for v in q_wxyz]
    n = max(np.sqrt(w * w + x * x + y * y + z * z), 1e-12)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _pose_mat(translation, rotation_wxyz) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = _quat_to_mat(rotation_wxyz)
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def _slerp(q0, q1, t: float) -> np.ndarray:
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def interpolated_timestamps(keyframe_ts: List[int],
                            n: int = HZ_FACTOR) -> np.ndarray:
    """2 Hz keyframe timestamps -> 10 Hz targets: n evenly spaced stamps per
    keyframe interval (reference get_interpolated_timestamps,
    nuscenes_preprocess.py:300-322)."""
    out = []
    for a, b in zip(keyframe_ts[:-1], keyframe_ts[1:]):
        out.extend(np.linspace(a, b, n, endpoint=False))
    out.append(keyframe_ts[-1])
    return np.asarray(out, np.int64)


def _closest(sds: List[dict], ts: int) -> dict:
    stamps = np.asarray([sd["timestamp"] for sd in sds], np.int64)
    return sds[int(np.argmin(np.abs(stamps - ts)))]


# --------------------------------------------------------------------------
# converter
# --------------------------------------------------------------------------


class NuScenesConverter:
    def __init__(self, data_root: str, target_dir: str,
                 version: str = "v1.0-mini",
                 cameras: List[str] = CAMERAS,
                 process_keys=("images", "calib", "lidar", "dynamic_masks",
                               "objects"),
                 device="cuda"):
        self.tables = Tables(data_root, version)
        self.device = torch.device(device)
        self.target = target_dir
        self.cameras = list(cameras)
        self.keys = set(process_keys)

    def convert_scene(self, scene_idx: int) -> str:
        scenes = self.tables.rows["scene"]
        scene = scenes[scene_idx]
        out = os.path.join(self.target, f"{scene_idx:03d}")
        samples = self.tables.scene_samples(scene)
        key_ts = [s["timestamp"] for s in samples]
        ts = interpolated_timestamps(key_ts)

        if "images" in self.keys or "calib" in self.keys:
            self._save_cameras(scene, ts, out)
        if "lidar" in self.keys:
            self._save_lidar(scene, ts, out)
        inst_info, frame_inst = self._build_objects(scene, samples, ts)
        if "objects" in self.keys:
            os.makedirs(os.path.join(out, "instances"), exist_ok=True)
            with open(os.path.join(out, "instances",
                                   "instances_info.json"), "w") as f:
                json.dump(inst_info, f)
            with open(os.path.join(out, "instances",
                                   "frame_instances.json"), "w") as f:
                json.dump(frame_inst, f)
        if "dynamic_masks" in self.keys:
            self._save_dynamic_masks(scene, ts, inst_info, out)
        return out

    # -- cameras ------------------------------------------------------------

    def _save_cameras(self, scene, ts, out):
        t = self.tables
        os.makedirs(os.path.join(out, "images"), exist_ok=True)
        os.makedirs(os.path.join(out, "extrinsics"), exist_ok=True)
        os.makedirs(os.path.join(out, "intrinsics"), exist_ok=True)
        for ci, channel in enumerate(self.cameras):
            sds = t.channel_sample_datas(scene, channel)
            if not sds:
                continue
            calib = t.get("calibrated_sensor",
                          sds[0]["calibrated_sensor_token"])
            K = np.asarray(calib["camera_intrinsic"], np.float64)
            np.savetxt(os.path.join(out, "intrinsics", f"{ci}.txt"),
                       np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
            for fi, stamp in enumerate(ts):
                sd = _closest(sds, stamp)
                if "images" in self.keys:
                    src = os.path.join(t.data_root, sd["filename"])
                    dst = os.path.join(out, "images",
                                       f"{fi:03d}_{ci}.jpg")
                    if os.path.exists(src):
                        shutil.copyfile(src, dst)
                ego = _pose_mat(*[t.get("ego_pose", sd["ego_pose_token"])[k]
                                  for k in ("translation", "rotation")])
                cal = t.get("calibrated_sensor",
                            sd["calibrated_sensor_token"])
                cam2ego = _pose_mat(cal["translation"], cal["rotation"])
                np.savetxt(os.path.join(out, "extrinsics",
                                        f"{fi:03d}_{ci}.txt"), ego @ cam2ego)

    # -- lidar --------------------------------------------------------------

    def _save_lidar(self, scene, ts, out):
        t = self.tables
        os.makedirs(os.path.join(out, "lidar"), exist_ok=True)
        os.makedirs(os.path.join(out, "lidar_pose"), exist_ok=True)
        sds = t.channel_sample_datas(scene, LIDAR)
        if not sds:
            return
        for fi, stamp in enumerate(ts):
            sd = _closest(sds, stamp)
            src = os.path.join(t.data_root, sd["filename"])
            if os.path.exists(src):
                # raw .pcd.bin: float32 (x, y, z, intensity, ring); keep xyzi
                raw = np.fromfile(src, np.float32).reshape(-1, 5)
                raw[:, :4].astype(np.float32).tofile(
                    os.path.join(out, "lidar", f"{fi:03d}.bin"))
            ego = _pose_mat(*[t.get("ego_pose", sd["ego_pose_token"])[k]
                              for k in ("translation", "rotation")])
            cal = t.get("calibrated_sensor", sd["calibrated_sensor_token"])
            np.savetxt(os.path.join(out, "lidar_pose", f"{fi:03d}.txt"),
                       ego @ _pose_mat(cal["translation"], cal["rotation"]))

    # -- objects ------------------------------------------------------------

    def _build_objects(self, scene, samples, ts):
        """Keyframe boxes -> 10 Hz interpolated instance tracks
        (interpolate_boxes, nuscenes_preprocess.py:854-922)."""
        t = self.tables
        per_instance: Dict[str, dict] = {}
        for si, s in enumerate(samples):
            for ann in t.rows["sample_annotation"]:
                if ann["sample_token"] != s["token"]:
                    continue
                inst = t.get("instance", ann["instance_token"])
                cat = t.get("category", inst["category_token"])["name"]
                rec = per_instance.setdefault(ann["instance_token"], {
                    "class_name": cat, "stamps": [], "trans": [],
                    "rots": [], "sizes": []})
                rec["stamps"].append(s["timestamp"])
                rec["trans"].append(ann["translation"])
                rec["rots"].append(ann["rotation"])
                # nuScenes size is (w, l, h); drivestudio boxes are (l, w, h)
                w, l, h = ann["size"]
                rec["sizes"].append([l, w, h])

        inst_info, frame_inst = {}, {fi: [] for fi in range(len(ts))}
        for ii, (tok, rec) in enumerate(sorted(per_instance.items())):
            stamps = np.asarray(rec["stamps"], np.int64)
            order = np.argsort(stamps)
            stamps = stamps[order]
            trans = np.asarray(rec["trans"], np.float64)[order]
            rots = [rec["rots"][i] for i in order]
            frames, o2ws = [], []
            for fi, stamp in enumerate(ts):
                if stamp < stamps[0] or stamp > stamps[-1]:
                    continue
                j = int(np.searchsorted(stamps, stamp, side="right") - 1)
                j = min(j, len(stamps) - 2) if len(stamps) > 1 else 0
                if len(stamps) == 1:
                    tr, q = trans[0], np.asarray(rots[0])
                else:
                    span = max(float(stamps[j + 1] - stamps[j]), 1.0)
                    a = float(stamp - stamps[j]) / span
                    tr = (1 - a) * trans[j] + a * trans[j + 1]
                    q = _slerp(rots[j], rots[j + 1], a)
                m = np.eye(4)
                m[:3, :3] = _quat_to_mat(q)
                m[:3, 3] = tr
                frames.append(fi)
                o2ws.append(m.tolist())
                frame_inst[fi].append(str(ii))
            inst_info[str(ii)] = {
                "id": str(ii), "token": tok,
                "class_name": rec["class_name"],
                "frame_annotations": {
                    "frame_idx": frames,
                    "obj_to_world": o2ws,
                    "box_size": [rec["sizes"][0]] * len(frames),
                },
            }
        return inst_info, frame_inst

    # -- dynamic masks ------------------------------------------------------

    def _save_dynamic_masks(self, scene, ts, inst_info, out):
        """Project interpolated 3D boxes; fill their convex hulls
        (save_dynamic_mask_interpolated, nuscenes_preprocess.py:694-787)."""
        t = self.tables
        for sub in ("all", "human", "vehicle"):
            os.makedirs(os.path.join(out, "dynamic_masks", sub),
                        exist_ok=True)
        from PIL import Image
        for ci, channel in enumerate(self.cameras):
            sds = t.channel_sample_datas(scene, channel)
            if not sds:
                continue
            for fi, stamp in enumerate(ts):
                sd = _closest(sds, stamp)
                cal = t.get("calibrated_sensor",
                            sd["calibrated_sensor_token"])
                K = np.asarray(cal["camera_intrinsic"], np.float64)
                ego = _pose_mat(
                    *[t.get("ego_pose", sd["ego_pose_token"])[k]
                      for k in ("translation", "rotation")])
                c2w = ego @ _pose_mat(cal["translation"], cal["rotation"])
                w2c = np.linalg.inv(c2w)
                hgt, wid = sd.get("height", 900), sd.get("width", 1600)
                polys, planes = [], []
                for iid, meta in inst_info.items():
                    cname = meta["class_name"]
                    if not cname.startswith(DYNAMIC_PREFIXES):
                        continue
                    ann = meta["frame_annotations"]
                    if fi not in ann["frame_idx"]:
                        continue
                    k = ann["frame_idx"].index(fi)
                    o2w = np.asarray(ann["obj_to_world"][k])
                    size = np.asarray(ann["box_size"][k])
                    poly = _project_box(o2w, size, w2c, K, wid, hgt)
                    if poly is None:
                        continue
                    polys.append(poly)
                    planes.append([True, cname.startswith(HUMAN_PREFIXES),
                                   cname.startswith(VEHICLE_PREFIXES)])
                filled = fill_convex(
                    polys, hgt, wid, self.device,
                    np.asarray(planes, bool).reshape(-1, 3)).cpu().numpy()
                masks = dict(zip(("all", "human", "vehicle"), filled))
                for sub, m in masks.items():
                    Image.fromarray((m * 255).astype(np.uint8)).save(
                        os.path.join(out, "dynamic_masks", sub,
                                     f"{fi:03d}_{ci}.png"))


def _project_box(o2w, size, w2c, K, width, height):
    """3D box corners -> image polygon (None if fully behind camera)."""
    l, w, h = [float(x) for x in size]
    corners = np.array([[sx * l / 2, sy * w / 2, sz * h / 2]
                        for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)])
    pts = corners @ o2w[:3, :3].T + o2w[:3, 3]
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    front = cam[:, 2] > 0.1
    if not front.any():
        return None
    cam = cam[front]
    uv = cam[:, :2] / cam[:, 2:3]
    px = uv * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])
    if (px[:, 0] < -width).all() or (px[:, 0] > 2 * width).all() \
            or (px[:, 1] < -height).all() or (px[:, 1] > 2 * height).all():
        return None
    return _convex_hull(px)


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain (<= 8 points; no scipy dependency)."""
    pts = np.unique(np.round(pts, 3), axis=0)
    if pts.shape[0] < 3:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def fill_convex(polys, height: int, width: int, device="cuda",
                planes=None) -> torch.Tensor:
    """The JAX package's `_fill_convex` (a convex polygon rasterised into a
    bool mask) of every polygon in `polys`, in one batched pass on
    `device`: (P, height, width) bool, plane p the union of the polygons i
    with planes[i, p] (default: one plane per polygon).

    Each polygon's pixels are those of its clipped bounding box, enumerated
    together as one ragged list; every edge's half-plane test is the JAX
    package's (b0 - a0) * (gy - a1) - (b1 - a1) * (gx - a0) >= 0, formed
    one eager op at a time in float64 (edge differences on the host, as
    numpy forms them; the two products per row and per column, their
    difference per pixel), so no pixel on an edge flips. Polygons with fewer
    edges are padded with zero-length edges, whose test is 0 >= 0."""
    dev = torch.device(device)
    planes = (np.eye(len(polys), dtype=bool) if planes is None
              else np.asarray(planes, bool))
    out = torch.zeros((planes.shape[1], height, width), dtype=torch.bool,
                      device=dev)
    keep, rects = [], []
    for i, poly in enumerate(polys):
        if poly.shape[0] < 3:
            continue
        x0 = int(max(np.floor(poly[:, 0].min()), 0))
        x1 = int(min(np.ceil(poly[:, 0].max()) + 1, width))
        y0 = int(max(np.floor(poly[:, 1].min()), 0))
        y1 = int(min(np.ceil(poly[:, 1].max()) + 1, height))
        if x1 <= x0 or y1 <= y0:
            continue
        keep.append(i)
        rects.append((x0, y0, x1 - x0, y1 - y0))
    if not keep:
        return out
    n_edges = max(polys[i].shape[0] for i in keep)
    # edge starts a and differences b - a, (boxes, edges, 2), float64
    a = np.zeros((len(keep), n_edges, 2))
    d = np.zeros((len(keep), n_edges, 2))
    for k, i in enumerate(keep):
        poly = np.asarray(polys[i], np.float64)
        m = poly.shape[0]
        a[k, :m] = poly
        d[k, :m] = np.roll(poly, -1, axis=0) - poly
        a[k, m:] = poly[0]
    rects = np.asarray(rects, np.int64)
    t = lambda x: torch.as_tensor(x, device=dev)           # noqa: E731
    # a box's rows and columns, each list box after box: gy, gx and the
    # ids of their box
    rows = [np.arange(y0, y0 + h) for _, y0, _, h in rects]
    cols = [np.arange(x0, x0 + w) for x0, _, w, _ in rects]
    row_box = t(np.repeat(np.arange(len(keep)), rects[:, 3]))
    col_box = t(np.repeat(np.arange(len(keep)), rects[:, 2]))
    ys, xs = t(np.concatenate(rows)), t(np.concatenate(cols))
    gy, gx = ys.double() + 0.5, xs.double() + 0.5
    # each pixel: its box's row and column in those lists
    sizes = rects[:, 2] * rects[:, 3]
    box = torch.repeat_interleave(t(np.arange(len(keep))), t(sizes))
    k = torch.arange(int(sizes.sum()), device=dev) - t(
        np.cumsum(sizes) - sizes)[box]
    w = t(rects[:, 2])[box]
    r = torch.div(k, w, rounding_mode="floor")
    row = t(np.cumsum(rects[:, 3]) - rects[:, 3])[box] + r
    col = t(np.cumsum(rects[:, 2]) - rects[:, 2])[box] + (k - r * w)
    a, d = t(a), t(d)
    inside = torch.ones(k.shape, dtype=torch.bool, device=dev)
    for e in range(n_edges):
        # CCW hull: interior is on the left of each edge. The first
        # product depends on the row only, the second on the column only:
        # each is formed once per row or column, with the ops the JAX
        # package applies per pixel
        lhs = torch.mul(d[:, e, 0][row_box],
                        torch.sub(gy, a[:, e, 1][row_box]))
        rhs = torch.mul(d[:, e, 1][col_box],
                        torch.sub(gx, a[:, e, 0][col_box]))
        inside &= torch.sub(lhs[row], rhs[col]) >= 0
    flat = ys[row] * width + xs[col]
    member = t(planes[keep])                                # (boxes, P)
    for p in range(planes.shape[1]):
        sel = inside & member[box, p]
        out[p].view(-1)[flat[sel]] = True
    return out
