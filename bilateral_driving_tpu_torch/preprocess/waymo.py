"""Raw Waymo Open Dataset -> drivestudio-layout converter (port of
bilateral_driving_tpu/preprocess/waymo.py).

Counterpart of the reference's `WaymoProcessor`
(project/datasets/waymo/waymo_preprocess.py:54-538). Waymo ships scenes as
TFRecord files of `waymo_open_dataset.dataset_pb2.Frame` protos; the TFRecord
*framing* is parsed here in pure python (no tensorflow), but decoding the
Frame message requires the `waymo_open_dataset` protobuf schema — an external
pip package that (like the raw data itself) is not part of this image. The
converter is therefore runnable exactly when the data is: install
`waymo-open-dataset-tf-*` wherever the TFRecords live.

Output layout matches data/scene.py's waymo flavor (data/meta.py): ego_pose/
per-frame vehicle pose, per-camera static extrinsics, images keyed
{frame:03d}_{cam}.jpg with cameras ordered FRONT, FRONT_LEFT, FRONT_RIGHT,
SIDE_LEFT, SIDE_RIGHT.

The lidar's per-point work and the mask projections run on `device`
(default cuda) through waymo_lidar.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List

import numpy as np

from . import waymo_lidar

CAMERA_ORDER = [1, 2, 3, 4, 5]   # FRONT, FRONT_LEFT, FRONT_RIGHT, SIDE_L/R
# waymo label types -> drivestudio class names (waymo_preprocess save_objects)
LABEL_TO_CLASS = {1: "Car", 2: "Pedestrian", 4: "Cyclist"}
# label type -> reference WAYMO_CLASSES name (waymo_preprocess.py:48-52)
TYPE_TO_NAME = {0: "unknown", 1: "Vehicle", 2: "Pedestrian", 3: "Sign",
                4: "Cyclist"}
DYNAMIC_CLASS_SETS = {
    "all": {"Vehicle", "Pedestrian", "Cyclist"},
    "human": {"Pedestrian", "Cyclist"},
    "vehicle": {"Vehicle"},
}
TOP_LIDAR = 1                     # dataset_pb2.LaserName.TOP


def read_tfrecord(path: str) -> Iterator[bytes]:
    """Iterate raw records of a TFRecord file (pure python: 8-byte LE length,
    4-byte length CRC, payload, 4-byte payload CRC)."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return
            (length,) = struct.unpack("<Q", hdr)
            f.read(4)                      # length crc (unchecked)
            payload = f.read(length)
            f.read(4)                      # data crc (unchecked)
            yield payload


def _require_proto():
    try:
        from waymo_open_dataset import dataset_pb2  # noqa: F401
        return dataset_pb2
    except ImportError as e:
        raise RuntimeError(
            "decoding Waymo Frame protos needs the `waymo_open_dataset` "
            "package (pip install waymo-open-dataset-tf-2-11-0); the raw "
            "TFRecords and this schema live together — run the converter "
            "in that environment") from e


def convert_scene(data_root: str, target_dir: str, scene_idx: int,
                  process_keys=("images", "calib", "lidar", "dynamic_masks",
                                "objects"),
                  device="cuda") -> str:
    """Convert the scene_idx-th TFRecord under data_root."""
    dataset_pb2 = _require_proto()
    files = sorted(f for f in os.listdir(data_root)
                   if f.endswith(".tfrecord"))
    path = os.path.join(data_root, files[scene_idx])
    out = os.path.join(target_dir, f"{scene_idx:03d}")
    keys = set(process_keys)
    for sub in ("images", "extrinsics", "intrinsics", "ego_pose", "lidar",
                "instances"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)

    instances: dict = {}
    frame_instances: dict = {}
    for fi, rec in enumerate(read_tfrecord(path)):
        frame = dataset_pb2.Frame()
        frame.ParseFromString(rec)
        v2w = np.array(frame.pose.transform, np.float64).reshape(4, 4)
        np.savetxt(os.path.join(out, "ego_pose", f"{fi:03d}.txt"), v2w)
        if "images" in keys or "calib" in keys:
            _save_frame_cameras(frame, v2w, fi, out, keys)
        if "lidar" in keys:
            _save_frame_lidar(frame, dataset_pb2, fi, out, device)
        if "dynamic_masks" in keys:
            for class_valid in ("all", "human", "vehicle"):
                _save_dynamic_masks(frame, fi, out, class_valid, device)
        if "objects" in keys:
            _collect_frame_objects(frame, v2w, fi, instances,
                                   frame_instances)

    if "objects" in keys:
        import json

        with open(os.path.join(out, "instances",
                               "instances_info.json"), "w") as f:
            json.dump(instances, f)
        with open(os.path.join(out, "instances",
                               "frame_instances.json"), "w") as f:
            json.dump(frame_instances, f)
    return out


def _save_frame_cameras(frame, v2w, fi, out, keys):
    for ci, cam_id in enumerate(CAMERA_ORDER):
        img = next((im for im in frame.images if im.name == cam_id), None)
        calib = next((c for c in frame.context.camera_calibrations
                      if c.name == cam_id), None)
        if img is None or calib is None:
            continue
        if "images" in keys:
            with open(os.path.join(out, "images",
                                   f"{fi:03d}_{ci}.jpg"), "wb") as f:
                f.write(img.image)
        if "calib" in keys:
            fx, fy, cx, cy = calib.intrinsic[0:4]
            k1, k2, p1, p2, k3 = calib.intrinsic[4:9]
            np.savetxt(os.path.join(out, "intrinsics", f"{ci}.txt"),
                       np.array([fx, fy, cx, cy, k1, k2, p1, p2, k3]))
            # waymo camera frame is x-forward; convert to OpenCV-style
            # cam-to-vehicle then store cam-to-world per frame
            cam2v = np.array(calib.extrinsic.transform,
                             np.float64).reshape(4, 4)
            opencv2cam = np.array([[0, 0, 1, 0], [-1, 0, 0, 0],
                                   [0, -1, 0, 0], [0, 0, 0, 1]], np.float64)
            np.savetxt(os.path.join(out, "extrinsics",
                                    f"{fi:03d}_{ci}.txt"),
                       v2w @ cam2v @ opencv2cam)


def _decode_matrix(compressed: bytes, msg) -> np.ndarray:
    """ZLIB-compressed MatrixFloat/MatrixInt32 -> numpy (the devkit's
    tf.io.decode_compressed + MatrixFloat.ParseFromString, in pure python)."""
    msg.ParseFromString(zlib.decompress(compressed))
    return np.array(msg.data, np.float32).reshape(list(msg.shape.dims))


def _save_frame_lidar(frame, dataset_pb2, fi, out, device="cuda"):
    """First-return point cloud of all five lidars as the 14-column .bin the
    data layer's waymo14 format reads (reference save_lidar,
    waymo_preprocess.py:253-323): origins(3) points(3) flow(4) ground(1)
    intensity(1) elongation(1) laser_id(1), in the frame's vehicle frame.

    The TOP lidar applies the per-column rolling-shutter pixel pose. Scene
    flow columns come from range_image_flow_compressed when present (the
    `*_with_flow` data variant); otherwise flow xyz = 0 and class = -1
    ("no-flow-label", same convention the reference documents at
    waymo_preprocess.py:299-305)."""
    frame_pose = np.array(frame.pose.transform, np.float64).reshape(4, 4)
    top_pose = None
    rows = []
    calibs = {c.name: c for c in frame.context.laser_calibrations}
    lasers = sorted(frame.lasers, key=lambda l: l.name)
    for laser in lasers:
        ri = laser.ri_return1
        if not ri.range_image_compressed:
            continue
        img = _decode_matrix(ri.range_image_compressed,
                             dataset_pb2.MatrixFloat())      # (H, W, 4)
        if laser.name == TOP_LIDAR and ri.range_image_pose_compressed:
            pose6 = _decode_matrix(ri.range_image_pose_compressed,
                                   dataset_pb2.MatrixFloat())  # (H, W, 6)
            top_pose = waymo_lidar.poses_from_6dof(pose6)
        flow = None
        if ri.range_image_flow_compressed:
            flow = _decode_matrix(ri.range_image_flow_compressed,
                                  dataset_pb2.MatrixFloat())  # (H, W, 4)

        c = calibs[laser.name]
        H, W = img.shape[0], img.shape[1]
        if len(c.beam_inclinations):
            incl = np.array(c.beam_inclinations, np.float64)
        else:
            incl = waymo_lidar.compute_inclination(
                c.beam_inclination_min, c.beam_inclination_max, H)
        incl = incl[::-1]                  # row 0 = top beam (devkit reverse)
        extrinsic = np.array(c.extrinsic.transform, np.float64).reshape(4, 4)
        pixel_pose = top_pose if laser.name == TOP_LIDAR else None
        pts, origins = waymo_lidar.extract_point_cloud(
            img[..., 0], extrinsic, incl, pixel_pose=pixel_pose,
            frame_pose=frame_pose if pixel_pose is not None else None,
            device=device)
        hit = img[..., 0] > 0
        n = int(hit.sum())
        if n == 0:
            continue
        f = np.full((n, 4), [0.0, 0.0, 0.0, -1.0], np.float32) \
            if flow is None else flow[hit]
        rows.append(np.column_stack([
            origins[hit].astype(np.float32), pts[hit].astype(np.float32),
            f.astype(np.float32),
            np.zeros((n, 1), np.float32),          # ground, filled below
            img[..., 1][hit], img[..., 2][hit],
            np.full((n,), laser.name - 1, np.float32),
        ]))
    if not rows:
        return
    pc = np.concatenate(rows, axis=0)
    pc[:, 10:11] = waymo_lidar.ground_mask(pc[:, 3:6], device=device
                                           ).astype(np.float32)
    pc.astype(np.float32).tofile(os.path.join(out, "lidar", f"{fi:03d}.bin"))


def _save_dynamic_masks(frame, fi, out, class_valid: str, device="cuda"):
    """Speed-thresholded 2-D box masks per camera (reference
    save_dynamic_mask, waymo_preprocess.py:344-455): project each lidar
    label's 3-D box corners into the image, draw its axis-aligned rectangle
    at the label's speed, threshold at 1 m/s."""
    from PIL import Image

    valid = DYNAMIC_CLASS_SETS[class_valid]
    mask_dir = os.path.join(out, "dynamic_masks", class_valid)
    os.makedirs(mask_dir, exist_ok=True)
    filter_available = any(l.num_top_lidar_points_in_box > 0
                           for l in frame.laser_labels)
    calibs = {c.name: c for c in frame.context.camera_calibrations}
    for img in frame.images:
        c = calibs[img.name]
        boxes = []
        for label in frame.laser_labels:
            if TYPE_TO_NAME.get(label.type, "unknown") not in valid:
                continue
            b = label.box
            if not b.ByteSize():
                continue
            if (filter_available and not label.num_top_lidar_points_in_box) \
                    or (not filter_available
                        and not label.num_lidar_points_in_box):
                continue                   # likely fully occluded
            speed = float(np.linalg.norm(
                [label.metadata.speed_x, label.metadata.speed_y]))
            corners = waymo_lidar.box_corners_3d(
                [b.center_x, b.center_y, b.center_z],
                [b.length, b.width, b.height], b.heading)
            boxes.append((corners, speed))
        mask = np.zeros((c.height, c.width), np.float32)
        cam2v = np.array(c.extrinsic.transform, np.float64).reshape(4, 4)
        waymo_lidar.draw_speed_mask(mask, boxes, cam2v,
                                    np.array(c.intrinsic, np.float64),
                                    device)
        png = ((mask > 1.0) * 255).astype(np.uint8)   # 1 m/s threshold
        ci = img.name - 1
        Image.fromarray(png, "L").save(
            os.path.join(mask_dir, f"{fi:03d}_{ci}.png"))


def _collect_frame_objects(frame, v2w, fi, instances, frame_instances):
    ids: List[str] = []
    for label in frame.laser_labels:
        if label.type not in LABEL_TO_CLASS:
            continue
        b = label.box
        heading = float(b.heading)
        o2v = np.eye(4)
        c, s = np.cos(heading), np.sin(heading)
        o2v[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        o2v[:3, 3] = [b.center_x, b.center_y, b.center_z]
        o2w = v2w @ o2v
        rec = instances.setdefault(label.id, {
            "id": label.id, "class_name": LABEL_TO_CLASS[label.type],
            "frame_annotations": {"frame_idx": [], "obj_to_world": [],
                                  "box_size": []}})
        ann = rec["frame_annotations"]
        ann["frame_idx"].append(fi)
        ann["obj_to_world"].append(o2w.tolist())
        ann["box_size"].append([b.length, b.width, b.height])
        ids.append(label.id)
    frame_instances[fi] = ids
