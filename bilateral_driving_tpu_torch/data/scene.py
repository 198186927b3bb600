"""Scene dataset over the drivestudio processed on-disk format: port of
bilateral_driving_tpu/data/scene.py.

  scene_dir/
    images/{t:03d}_{cam}.jpg          RGB frames
    sky_masks/{t:03d}_{cam}.png       sky segmentation (>0 = sky)
    dynamic_masks|fine_dynamic_masks/{all,human,vehicle}/{t:03d}_{cam}.png
    extrinsics/{t:03d}_{cam}.txt      4x4 camera-to-world per frame
    intrinsics/{cam}.txt              fx fy cx cy
    lidar/{t:03d}.bin                 float32 (N, 4) xyzi
    lidar_pose/{t:03d}.txt            4x4 lidar-to-world
    instances/instances_info.json     {id: {class_name, frame_annotations:
                                      {frame_idx, obj_to_world (4x4), box_size}}}
    instances/frame_instances.json    {frame: [ids]}

Loading is host-side numpy, as in the JAX package, and every array equals
the JAX package's; `SceneData.get_batch` hands one image to the trainer as
tensors on the scene's device. Images and masks are decoded by PIL, or read
from a pixel pack (tools/pack_scene.py: the same decoded arrays in one
.npz, keyed by their path under the scene directory), so a machine without
PIL loads a packed scene; resizing at load (`data.downscale`) is the port's
own, equal to PIL's (`resize`). Tracked SMPL poses
come from `humanpose/smpl.pkl` (`load_smpl_poses`).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import logging
import math
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import transforms
from . import meta as meta_mod

# datasets whose cameras see the ego car
# (bilateral_driving_tpu/preprocess/ego_masks.py)
NEEDS_EGO_MASKS = ("nuscenes", "pandaset", "nuplan", "argoverse")


@dataclasses.dataclass
class InstanceAnnotations:
    """Per-frame instance annotations (pixel_source.py:680-690 equivalents)."""
    ids: List[str]
    class_names: List[str]
    node_types: List[str]                 # RigidNodes | SMPLNodes | DeformableNodes
    poses: np.ndarray                     # (F, I, 4, 4) obj-to-world
    sizes: np.ndarray                     # (I, 3)
    frame_valid: np.ndarray               # (F, I) bool


# nuScenes class -> node type mapping (nuscenes_sourceloader.py:21-51)
DEFAULT_CLASS_TO_NODE = {
    "vehicle.car": "RigidNodes",
    "vehicle.truck": "RigidNodes",
    "vehicle.bus": "RigidNodes",
    "vehicle.trailer": "RigidNodes",
    "vehicle.construction": "RigidNodes",
    "vehicle.emergency": "RigidNodes",
    "vehicle.motorcycle": "DeformableNodes",
    "vehicle.bicycle": "DeformableNodes",
    "human.pedestrian": "SMPLNodes",
    "human.pedestrian.adult": "SMPLNodes",
    "human.pedestrian.child": "SMPLNodes",
    # KITTI labels (kitti_sourceloader.py:23-35)
    "Car": "RigidNodes",
    "Van": "RigidNodes",
    "Truck": "RigidNodes",
    "Tram": "RigidNodes",
    "Pedestrian": "SMPLNodes",
    "Person_sitting": "SMPLNodes",
    "Cyclist": "DeformableNodes",
    # PandaSet labels (pandaset_sourceloader.py:23-44)
    "Bus": "RigidNodes",
    "Emergency Vehicle": "RigidNodes",
    "Medium-sized Truck": "RigidNodes",
    "Motorcycle": "RigidNodes",
    "Motorized Scooter": "RigidNodes",
    "Other Vehicle - Construction Vehicle": "RigidNodes",
    "Other Vehicle - Pedicab": "RigidNodes",
    "Other Vehicle - Uncommon": "RigidNodes",
    "Pickup Truck": "RigidNodes",
    "Semi-truck": "RigidNodes",
    "Train": "RigidNodes",
    "Tram / Subway": "RigidNodes",
    "Pedestrian with Object": "SMPLNodes",
    "Bicycle": "DeformableNodes",
    "Animals - Other": "DeformableNodes",
    "Personal Mobility Device": "DeformableNodes",
    # Argoverse-2 labels (argoverse_sourceloader.py:23-56)
    "ARTICULATED_BUS": "RigidNodes",
    "BOLLARD": "RigidNodes",
    "BOX_TRUCK": "RigidNodes",
    "BUS": "RigidNodes",
    "CONSTRUCTION_BARREL": "RigidNodes",
    "CONSTRUCTION_CONE": "RigidNodes",
    "LARGE_VEHICLE": "RigidNodes",
    "MESSAGE_BOARD_TRAILER": "RigidNodes",
    "MOBILE_PEDESTRIAN_CROSSING_SIGN": "RigidNodes",
    "MOTORCYCLE": "RigidNodes",
    "RAILED_VEHICLE": "RigidNodes",
    "REGULAR_VEHICLE": "RigidNodes",
    "SCHOOL_BUS": "RigidNodes",
    "SIGN": "RigidNodes",
    "STOP_SIGN": "RigidNodes",
    "TRAFFIC_LIGHT_TRAILER": "RigidNodes",
    "TRUCK": "RigidNodes",
    "TRUCK_CAB": "RigidNodes",
    "VEHICULAR_TRAILER": "RigidNodes",
    "OFFICIAL_SIGNALER": "SMPLNodes",
    "PEDESTRIAN": "SMPLNodes",
    "ANIMAL": "DeformableNodes",
    "BICYCLE": "DeformableNodes",
    "BICYCLIST": "DeformableNodes",
    "DOG": "DeformableNodes",
    "MOTORCYCLIST": "DeformableNodes",
    "STROLLER": "DeformableNodes",
    "WHEELCHAIR": "DeformableNodes",
    "WHEELED_DEVICE": "DeformableNodes",
    "WHEELED_RIDER": "DeformableNodes",
    # nuPlan labels (nuplan_sourceloader.py:22-24)
    "vehicle": "RigidNodes",
    "pedestrian": "SMPLNodes",
    "bicycle": "DeformableNodes",
}


@dataclasses.dataclass
class SceneData:
    images: np.ndarray          # (N_img, H, W, 3) float32 [0, 1]
    sky_masks: np.ndarray       # (N_img, H, W) float32
    dynamic_masks: np.ndarray   # (N_img, H, W)
    human_masks: np.ndarray
    vehicle_masks: np.ndarray
    cam_to_worlds: np.ndarray   # (N_img, 4, 4)
    intrinsics: np.ndarray      # (N_img, 3, 3)
    frame_of_image: np.ndarray  # (N_img,) frame index per image
    cam_of_image: np.ndarray    # (N_img,) camera index per image
    lidar_points: List[np.ndarray]   # per frame (M, 3) world xyz
    lidar_depth_maps: Optional[np.ndarray]  # (N_img, H, W)
    instances: Optional[InstanceAnnotations]
    num_frames: int
    num_cams: int
    width: int
    height: int
    # per-camera ego-vehicle occlusion mask (H, W) float32, 1 = ego car
    egocar_masks: Optional[np.ndarray] = None   # (num_cams, H, W)
    # tracked SMPL body poses per instance id (load_smpl_poses), or None
    smpl_poses: Optional[Dict[str, Dict[str, np.ndarray]]] = None
    # source dataset key ("waymo", "nuscenes/6cams", ...); None = unknown
    dataset: Optional[str] = None
    # where get_batch puts its tensors
    device: str = "cuda"

    def camera_names(self) -> List[str]:
        layout = meta_mod.get_layout(self.dataset)
        if layout is None:
            return [f"cam_{i}" for i in range(self.num_cams)]
        return [layout.cameras[i].name if i in layout.cameras else f"cam_{i}"
                for i in range(self.num_cams)]

    @property
    def num_images(self) -> int:
        return self.images.shape[0]

    def normalized_time(self, frame) -> float:
        return float(frame) / max(self.num_frames - 1, 1)

    # ---- splits (driving_dataset.py:605-642) ----
    def split_train_test(self, test_stride: int):
        frames = np.arange(self.num_frames)
        if test_stride <= 0:
            test_frames = np.array([], np.int64)
        else:
            test_frames = frames[test_stride::test_stride]
        is_test_frame = np.isin(self.frame_of_image, test_frames)
        return (np.where(~is_test_frame)[0], np.where(is_test_frame)[0])

    def neighbor_train_indices(self, test_stride: int, k: int = 2):
        """test image -> k neighboring train images of the same camera
        (driving_dataset.py:111-126; used for bilateral-grid averaging)."""
        train_idx, test_idx = self.split_train_test(test_stride)
        out = {}
        for ti in test_idx:
            cam = self.cam_of_image[ti]
            frame = self.frame_of_image[ti]
            same_cam = train_idx[self.cam_of_image[train_idx] == cam]
            order = np.argsort(np.abs(self.frame_of_image[same_cam] - frame))
            out[int(ti)] = same_cam[order[:k]].astype(np.int64)
        return out

    # ---- batch assembly (pixel_source.py:477-657 CameraData.get_image) ----
    def get_batch(self, image_idx: int, downscale: int = 1) -> Dict:
        """One image as the trainer's batch: tensors on `device`, with
        img_idx and frame_idx as ints and normed_time as a float."""
        img = self.images[image_idx]
        sky = self.sky_masks[image_idx]
        depth = (self.lidar_depth_maps[image_idx]
                 if self.lidar_depth_maps is not None
                 else np.zeros(img.shape[:2], np.float32))
        K = self.intrinsics[image_idx].copy()
        if downscale > 1:
            img = img[::downscale, ::downscale]
            sky = sky[::downscale, ::downscale]
            depth = _sparse_depth_downsample(depth, downscale)
            K[:2] /= downscale
        h, w = img.shape[:2]
        c2w = self.cam_to_worlds[image_idx]
        frame = int(self.frame_of_image[image_idx])
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        batch = {
            "pixels": to(img),
            "sky_masks": to(sky),
            "lidar_depth_map": to(depth),
            "viewdirs": to(_pixel_viewdirs(h, w, K, c2w)),
            "img_idx": int(image_idx),
            "frame_idx": frame,
            "normed_time": self.normalized_time(frame),
            "camera_to_world": to(c2w),
            "intrinsics": to(K),
        }
        if self.egocar_masks is not None:
            ego = self.egocar_masks[self.cam_of_image[image_idx]]
            if downscale > 1:
                ego = ego[::downscale, ::downscale]
            batch["egocar_masks"] = to(ego)
        return batch

    # ---- scene geometry ----
    def aabb(self) -> np.ndarray:
        """Scene AABB from the front-camera trajectory, reference semantics
        (pixel_source.py:754-785): +/-40 m on the two horizontal axes; the
        vertical axis extends +20 m clamped to <= 20 (uphill) and -5 m
        clamped to >= -5 (downhill)."""
        front = self.cam_of_image == 0
        centers = self.cam_to_worlds[front, :3, 3]
        if centers.shape[0] == 0:
            centers = self.cam_to_worlds[:, :3, 3]
        lo = centers.min(0).astype(np.float64)
        hi = centers.max(0).astype(np.float64)
        hi[0] += 40.0
        hi[1] += 40.0
        hi[2] = min(hi[2] + 20.0, 20.0)
        lo[0] -= 40.0
        lo[1] -= 40.0
        lo[2] = max(lo[2] - 5.0, -5.0)
        hi = np.maximum(hi, lo + 1e-3)
        return np.stack([lo, hi]).astype(np.float32)

    def scene_radius(self) -> float:
        centers = self.cam_to_worlds[:, :3, 3]
        return float(np.linalg.norm(centers - centers.mean(0), axis=-1).max()
                     + 10.0)


def _pixel_viewdirs(h, w, K, c2w):
    xs = (np.arange(w) + 0.5 - K[0, 2]) / K[0, 0]
    ys = (np.arange(h) + 0.5 - K[1, 2]) / K[1, 1]
    d = np.stack(np.broadcast_arrays(xs[None, :], ys[:, None],
                                     np.ones((1, 1))), axis=-1)
    d = d @ c2w[:3, :3].T
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _sparse_depth_downsample(depth, factor):
    """Mean of the lidar hits in each block (zeros excluded), zero where a
    block has none (pixel_source.py:77-92). Output dims ceil(h/f), like
    `[::f]` slicing of the image."""
    h, w = depth.shape
    h2, w2 = -(-h // factor), -(-w // factor)
    d = np.pad(depth, ((0, h2 * factor - h), (0, w2 * factor - w)))
    d = d.reshape(h2, factor, w2, factor)
    hits = (d > 1e-3).sum(axis=(1, 3))
    total = d.sum(axis=(1, 3))
    return np.where(hits > 0, total / np.maximum(hits, 1),
                    0.0).astype(depth.dtype)


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------


class PixelSource:
    """Decoded uint8 images (RGB) and masks (L) of a scene: from a pixel
    pack when one is given, else from the files through PIL."""

    def __init__(self, scene_dir: str, pack: Optional[str] = None):
        self.scene_dir = scene_dir
        self.pack = None if pack is None else np.load(pack)

    def exists(self, rel: str) -> bool:
        if self.pack is not None:
            return rel in self.pack.files
        return os.path.exists(os.path.join(self.scene_dir, rel))

    def read(self, rel: str, mode: str) -> np.ndarray:
        """(H, W, 3) for mode "RGB", (H, W) for "L"; uint8."""
        if self.pack is not None:
            a = self.pack[rel]
            want = 3 if mode == "RGB" else 2
            if a.ndim != want:
                raise ValueError(f"pixel pack entry {rel}: {a.shape}")
            return a
        from PIL import Image

        return np.asarray(Image.open(os.path.join(self.scene_dir, rel))
                          .convert(mode))


_PRECISION_BITS = 32 - 8 - 2     # PIL's fixed-point bits (Resample.c)


@functools.lru_cache(maxsize=32)
def _bilinear_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs for its triangle filter (support 1, widened
    by the scale when shrinking) and normalize_coeffs_8bpc: per output
    pixel the first input index and fixed-point weights (out, ksize).
    Cached per pair of sizes (a Python loop over the output pixels); read
    only."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = np.maximum(1.0 - np.abs(
            (np.arange(xmax) + xmin - center + 0.5) / filterscale), 0.0)
        total = w.sum()
        if total != 0.0:
            w = w / total
        # C's (int) truncates toward zero after the half is added
        kk[xx, :xmax] = np.trunc(
            np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS))
        xmins[xx] = xmin
    return xmins, kk


def _bilinear_pass(x: torch.Tensor, out_size: int,
                   axis: int) -> torch.Tensor:
    """One separable pass of PIL's 8-bit resampling along `axis` of a
    uint8 tensor, on its device: fixed-point sums in int32 as PIL's (a
    row's weights add to about 2^22, so a sum stays below
    255 * 2^22 + 2^21 < 2^31), rounded by half a unit, clipped to
    [0, 255]. Integer sums: the same bits on every device."""
    xmins, kk = _bilinear_coeffs(x.shape[axis], out_size)
    idx = torch.as_tensor(np.minimum(
        xmins[:, None] + np.arange(kk.shape[1])[None], x.shape[axis] - 1),
        device=x.device)
    w = torch.as_tensor(kk, dtype=torch.int32, device=x.device)
    src = x.movedim(axis, 0).to(torch.int32)
    shape = (out_size,) + (1,) * (src.dim() - 1)
    acc = torch.full((out_size,) + tuple(src.shape[1:]),
                     1 << (_PRECISION_BITS - 1), dtype=torch.int32,
                     device=x.device)
    for j in range(kk.shape[1]):
        acc += src[idx[:, j]] * w[:, j].reshape(shape)
    out = torch.clamp(acc >> _PRECISION_BITS, 0, 255).to(torch.uint8)
    return out.movedim(0, axis)


@functools.lru_cache(maxsize=32)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's nearest-neighbour scaling (ImagingScaleAffine): the source
    coordinate starts at half a step and adds the step per pixel, in
    double, truncated."""
    step = in_size / out_size
    out = np.empty(out_size, np.int64)
    v = step * 0.5
    for i in range(out_size):
        out[i] = min(int(v), in_size - 1)
        v += step
    return out


def resize(a, size, nearest: bool):
    """Resize a uint8 (H, W) or (H, W, C) image to size (W, H) as PIL's
    Image.resize does with NEAREST or BILINEAR, without PIL: bilinear is
    PIL's separable triangle filter (support widened by the scale when
    shrinking, horizontal pass first, 22-bit fixed-point weights, each pass
    rounded to uint8), nearest its truncated half-step sampling. A numpy
    array gives a numpy array (resized on the CPU); a tensor gives a
    tensor, resized on its device (preprocess/masks.py's image processor
    on the card). The identity (a copy) when the size already matches."""
    if isinstance(a, np.ndarray):
        return resize(torch.from_numpy(np.array(a)), size, nearest).numpy()
    w, h = size
    if a.shape[1] == w and a.shape[0] == h:
        return a.clone()
    if a.dtype != torch.uint8:
        raise TypeError(f"resize takes uint8 images, not {a.dtype}")
    if nearest:
        rows, cols = (torch.as_tensor(_nearest_index(n, m), device=a.device)
                      for n, m in ((a.shape[0], h), (a.shape[1], w)))
        return a[rows][:, cols]
    out = a
    if a.shape[1] != w:
        out = _bilinear_pass(out, w, axis=1)
    if a.shape[0] != h:
        out = _bilinear_pass(out, h, axis=0)
    return out


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------


def load_scene(
    scene_dir: str,
    cameras=(0,),
    start_frame: int = 0,
    end_frame: int = -1,
    load_size: Optional[tuple] = None,     # (H, W)
    downscale: float = 1.0,
    load_lidar: bool = True,
    compute_depth_maps: bool = True,
    class_to_node: Dict[str, str] = DEFAULT_CLASS_TO_NODE,
    dataset: Optional[str] = None,
    undistort: bool = False,
    ego_mask_dir: Optional[str] = None,
    pixel_pack: Optional[str] = None,
    device: str = "cuda",
) -> SceneData:
    """Load one processed drivestudio scene, as the JAX package's
    load_scene does. `pixel_pack` reads decoded images and masks from a
    pack written by tools/pack_scene.py instead of decoding the files;
    `device` is where get_batch puts its tensors."""
    src = PixelSource(scene_dir, pixel_pack)
    layout = meta_mod.get_layout(dataset)
    opencv_m = layout.opencv_mat() if layout is not None else np.eye(4)
    calib_style = layout.calib_style if layout is not None else "per_frame"
    lidar_format = layout.lidar_format if layout is not None else "xyzi"

    img_dir = os.path.join(scene_dir, "images")
    files = sorted(os.listdir(img_dir))
    frames_avail = sorted({int(f.split("_")[0]) for f in files})
    if end_frame < 0:
        end_frame = frames_avail[-1] + 1
    frames = [f for f in frames_avail if start_frame <= f < end_frame]
    num_frames = len(frames)

    # reference size from the first image
    probe = src.read(os.path.join("images", files[0]), "RGB")
    if load_size is None:
        load_size = (int(probe.shape[0] / downscale),
                     int(probe.shape[1] / downscale))
    H, W = load_size

    fine = os.path.join(scene_dir, "fine_dynamic_masks")
    dyn_dir = "fine_dynamic_masks" if os.path.isdir(fine) else "dynamic_masks"

    imgs, skys, dyns, hums, vehs = [], [], [], [], []
    c2ws, Ks, frame_of, cam_of = [], [], [], []

    # ---- per-camera calibration (intrinsics + distortion) ----
    cam_K, cam_dist = {}, {}
    for cam in cameras:
        intr = np.loadtxt(os.path.join(scene_dir, "intrinsics",
                                       f"{cam}.txt")).reshape(-1)
        fx, fy, cx, cy = intr[:4]
        cam_K[cam] = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        # columns 4:9 = k1 k2 p1 p2 k3 (nuscenes_sourceloader.py:91)
        cam_dist[cam] = intr[4:9] if intr.shape[0] >= 9 \
            else np.zeros(5)

    def _undistort(arr, cam):
        if not undistort or not np.any(cam_dist[cam]):
            return arr
        import cv2
        return cv2.undistort(arr, cam_K[cam], cam_dist[cam])

    def read_mask(rel, cam=None):
        if src.exists(rel):
            a = src.read(rel, "L")
            if cam is not None:
                a = _undistort(a, cam)
            a = resize(a, (W, H), nearest=True)
            return (a > 0).astype(np.float32)
        return np.zeros((H, W), np.float32)

    # ---- world recentering (nuscenes_sourceloader.py:76-78 front cam;
    # waymo_sourceloader.py:90-99 first ego pose) ----
    if calib_style == "ego_pose":
        ego0 = np.loadtxt(os.path.join(scene_dir, "ego_pose",
                                       f"{frames[0]:03d}.txt"))
        inv_first = np.linalg.inv(ego0)
        cam_to_ego = {cam: np.loadtxt(os.path.join(
            scene_dir, "extrinsics", f"{cam}.txt")) @ opencv_m
            for cam in cameras}
        ego_poses = {t: np.loadtxt(os.path.join(
            scene_dir, "ego_pose", f"{t:03d}.txt")) for t in frames}

        def cam_pose(t, cam):
            return inv_first @ ego_poses[t] @ cam_to_ego[cam]
    else:
        front0_path = os.path.join(scene_dir, "extrinsics",
                                   f"{frames[0]:03d}_{cameras[0]}.txt")
        inv_first = np.linalg.inv(np.loadtxt(front0_path)) \
            if os.path.exists(front0_path) else np.eye(4)

        def cam_pose(t, cam):
            c2w = np.loadtxt(os.path.join(
                scene_dir, "extrinsics", f"{t:03d}_{cam}.txt"))
            return inv_first @ c2w @ opencv_m

    for fi, t in enumerate(frames):
        for ci, cam in enumerate(cameras):
            rgb = src.read(os.path.join("images", f"{t:03d}_{cam}.jpg"),
                           "RGB")
            scale_x = W / rgb.shape[1]
            scale_y = H / rgb.shape[0]
            rgb = _undistort(rgb, cam)
            imgs.append(np.asarray(resize(rgb, (W, H), nearest=False),
                                   np.float32) / 255.0)
            name = f"{t:03d}_{cam}.png"
            skys.append(read_mask(os.path.join("sky_masks", name), cam))
            dyns.append(read_mask(os.path.join(dyn_dir, "all", name), cam))
            hums.append(read_mask(os.path.join(dyn_dir, "human", name), cam))
            vehs.append(read_mask(os.path.join(dyn_dir, "vehicle", name),
                                  cam))
            c2ws.append(cam_pose(t, cam))
            K = cam_K[cam]
            Ks.append(np.array(
                [[K[0, 0] * scale_x, 0, K[0, 2] * scale_x],
                 [0, K[1, 1] * scale_y, K[1, 2] * scale_y],
                 [0, 0, 1.0]]))
            frame_of.append(fi)
            cam_of.append(ci)

    # ---- per-camera ego-vehicle masks (pixel_source.py:261-281) ----
    # search order: explicit ego_mask_dir -> `<scene>/ego_masks/` ->
    # the repo-relative `data/ego_masks/<dataset>` asset path
    egocar = None
    candidates = [ego_mask_dir] if ego_mask_dir is not None else [
        os.path.join(scene_dir, "ego_masks"),
        os.path.join("data", "ego_masks", dataset.split("/")[0])
        if dataset is not None else None,
    ]
    ego_mask_dir = next((d for d in candidates
                         if d is not None and os.path.isdir(d)), None)
    if ego_mask_dir is not None:
        rows = []
        any_found = False
        ego_src = PixelSource(ego_mask_dir)
        for cam in cameras:
            if ego_src.exists(f"{cam}.png"):
                m = _undistort(ego_src.read(f"{cam}.png", "L"), cam)
                m = resize(m, (W, H), nearest=True)
                rows.append((m > 0).astype(np.float32))
                any_found = any_found or bool(rows[-1].any())
            else:
                rows.append(np.zeros((H, W), np.float32))
        if any_found:
            egocar = np.stack(rows)
    if egocar is None and dataset is not None \
            and dataset.split("/")[0] in NEEDS_EGO_MASKS:
        logging.getLogger("bilateral_driving_tpu_torch").warning(
            f"no (non-placeholder) ego-vehicle masks found for {dataset!r} "
            f"(searched {candidates}): ego-car pixels will enter the losses")

    lidar_pts = []
    if load_lidar and os.path.isdir(os.path.join(scene_dir, "lidar")):
        for t in frames:
            raw = np.fromfile(os.path.join(scene_dir, "lidar", f"{t:03d}.bin"),
                              dtype=np.float32)
            if lidar_format == "waymo14":
                # (N, 14) rows: origin(3) point(3) ... in the ego frame
                pts = raw.reshape(-1, 14)[:, 3:6]
                l2w = inv_first @ np.loadtxt(os.path.join(
                    scene_dir, "ego_pose", f"{t:03d}.txt"))
            elif lidar_format == "nuplan6":
                # (N, 6) [x y z intensity ring lidar_id] in the ego frame
                pts = raw.reshape(-1, 6)[:, :3]
                l2w = inv_first @ np.loadtxt(os.path.join(
                    scene_dir, "ego_pose", f"{t:03d}.txt"))
            elif lidar_format == "xyzil":
                # pandaset: (N, 5) [x y z intensity laser_id], ego frame
                pts = raw.reshape(-1, 5)[:, :3]
                l2w = inv_first @ np.loadtxt(os.path.join(
                    scene_dir, "ego_pose", f"{t:03d}.txt"))
            else:
                pts = raw.reshape(-1, 4)[:, :3]
                pose_f = os.path.join(scene_dir, "lidar_pose", f"{t:03d}.txt")
                l2w = np.loadtxt(pose_f) if os.path.exists(pose_f) \
                    else np.eye(4)
                l2w = inv_first @ l2w
            lidar_pts.append(
                (pts @ l2w[:3, :3].T + l2w[:3, 3]).astype(np.float32))
    else:
        lidar_pts = [np.zeros((0, 3), np.float32) for _ in frames]

    data = SceneData(
        images=np.stack(imgs),
        sky_masks=np.stack(skys),
        dynamic_masks=np.stack(dyns),
        human_masks=np.stack(hums),
        vehicle_masks=np.stack(vehs),
        cam_to_worlds=np.stack(c2ws).astype(np.float32),
        intrinsics=np.stack(Ks).astype(np.float32),
        frame_of_image=np.asarray(frame_of),
        cam_of_image=np.asarray(cam_of),
        lidar_points=lidar_pts,
        lidar_depth_maps=None,
        instances=load_instances(scene_dir, frames, inv_first, class_to_node),
        num_frames=num_frames,
        num_cams=len(cameras),
        width=W,
        height=H,
        egocar_masks=egocar,
        dataset=dataset,
        device=device,
    )
    if compute_depth_maps and any(p.shape[0] for p in lidar_pts):
        data.lidar_depth_maps = project_lidar_depth(data)
    data.smpl_poses = load_smpl_poses(scene_dir, frames, inv_first)
    return data


def load_smpl_poses(scene_dir, frames, inv_first):
    """Per-frame SMPL joint rotations from `humanpose/smpl.pkl` (the
    4D-Humans tracking output the reference reads at
    nuscenes_sourceloader.py:284-336).

    The file maps instance id -> {"valid_mask" (F_total,),
    "selected_cam_idx" (F_total,), "smpl": {"betas" (F, 10), "body_pose"
    (F, 23, 3, 3), "global_orient" (F, 3, 3)}}. The global orient, estimated
    in the camera the track was taken from, is rotated into the recentred
    world by that camera's c2w. Returns id -> {"quats" (F, 24, 4), "betas"
    (10,), "valid" (F,)} on the loaded frames, or None when absent. A plain
    pickle is read first; joblib (which may be absent) only for what pickle
    cannot read.
    """
    path = os.path.join(scene_dir, "humanpose", "smpl.pkl")
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            smpl_dict = pickle.load(f)
    except Exception:
        import joblib
        smpl_dict = joblib.load(path)

    out = {}
    F = len(frames)
    for iid, d in smpl_dict.items():
        quats = np.zeros((F, 24, 4), np.float32)
        quats[..., 0] = 1.0
        valid = np.zeros(F, bool)
        betas = np.zeros(10, np.float32)
        rots, got = [], []
        vm = np.asarray(d["valid_mask"])
        for fi, t in enumerate(frames):
            if t >= len(vm) or not vm[t]:
                continue
            body = np.asarray(d["smpl"]["body_pose"][t],
                              np.float32).reshape(23, 3, 3)
            orient = np.asarray(d["smpl"]["global_orient"][t],
                                np.float32).reshape(3, 3)
            cam = int(np.asarray(d["selected_cam_idx"][t]).reshape(()))
            c2w_path = os.path.join(scene_dir, "extrinsics",
                                    f"{t:03d}_{cam}.txt")
            if os.path.exists(c2w_path):
                c2w = inv_first @ np.loadtxt(c2w_path)
                orient = c2w[:3, :3].astype(np.float32) @ orient
            rots.append(np.concatenate([orient[None], body], axis=0))
            got.append(fi)
            valid[fi] = True
            betas = np.asarray(d["smpl"]["betas"][t],
                               np.float32).reshape(-1)[:10]
        if got:
            quats[np.asarray(got)] = transforms.rotmat_to_quat(
                torch.from_numpy(np.stack(rots))).numpy()
        out[str(iid)] = {"quats": quats, "betas": betas, "valid": valid}
    return out or None


def load_instances(scene_dir, frames, inv_first, class_to_node
                   ) -> Optional[InstanceAnnotations]:
    """instances_info.json + frame_instances.json (driving_dataset init path,
    nuscenes_sourceloader.py:221-236)."""
    path = os.path.join(scene_dir, "instances", "instances_info.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        info = json.load(f)
    ids = sorted(info.keys())
    F, I = len(frames), len(ids)
    poses = np.tile(np.eye(4, dtype=np.float32), (F, I, 1, 1))
    sizes = np.zeros((I, 3), np.float32)
    valid = np.zeros((F, I), bool)
    classes, node_types = [], []
    frame_to_local = {t: i for i, t in enumerate(frames)}
    for ii, iid in enumerate(ids):
        meta = info[iid]
        cls = meta.get("class_name", "vehicle.car")
        classes.append(cls)
        node_types.append(class_to_node.get(cls, "RigidNodes"))
        ann = meta["frame_annotations"]
        for fr, o2w, size in zip(ann["frame_idx"], ann["obj_to_world"],
                                 ann["box_size"]):
            if fr in frame_to_local:
                fl = frame_to_local[fr]
                poses[fl, ii] = inv_first @ np.asarray(o2w, np.float32)
                sizes[ii] = np.asarray(size, np.float32)
                valid[fl, ii] = True
    return InstanceAnnotations(ids=ids, class_names=classes,
                               node_types=node_types, poses=poses,
                               sizes=sizes, frame_valid=valid)


def project_lidar_depth(data: SceneData) -> np.ndarray:
    """Per-image sparse depth maps from the frame's lidar points
    (driving_dataset.py:644-727)."""
    out = np.zeros((data.num_images, data.height, data.width), np.float32)
    for i in range(data.num_images):
        frame = data.frame_of_image[i]
        pts = data.lidar_points[frame]
        if pts.shape[0] == 0:
            continue
        w2c = np.linalg.inv(data.cam_to_worlds[i])
        p_cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = p_cam[:, 2]
        front = z > 0.5
        p = p_cam[front]
        z = z[front]
        K = data.intrinsics[i]
        u = (p[:, 0] / p[:, 2] * K[0, 0] + K[0, 2]).astype(np.int64)
        v = (p[:, 1] / p[:, 2] * K[1, 1] + K[1, 2]).astype(np.int64)
        ok = (u >= 0) & (u < data.width) & (v >= 0) & (v < data.height)
        u, v, z = u[ok], v[ok], z[ok]
        # keep nearest per pixel
        order = np.argsort(-z)
        out[i, v[order], u[order]] = z[order]
    return out


# --------------------------------------------------------------------------
# initialization point extraction (driving_dataset.py:280-574)
# --------------------------------------------------------------------------


def get_init_objects(data: SceneData, node_type, max_pts: int = 5000,
                     only_moving: bool = True, traj_length_thres: float = 0.5,
                     seed: int = 0):
    """Aggregate lidar points inside each instance's boxes across frames,
    expressed in the instance frame (driving_dataset.py:280-416). Returns
    dict with local points/colors per instance + pose tracks.

    node_type: one node class or a tuple of classes (with SMPL off the
    SMPL-class instances go to DeformableNodes)."""
    inst = data.instances
    if inst is None:
        return None
    types = (node_type,) if isinstance(node_type, str) else tuple(node_type)
    sel = [i for i, nt in enumerate(inst.node_types) if nt in types]
    if only_moving:
        moving = []
        for i in sel:
            frames = np.where(inst.frame_valid[:, i])[0]
            if len(frames) < 2:
                continue
            traj = inst.poses[frames, i, :3, 3]
            if np.linalg.norm(traj[-1] - traj[0]) > traj_length_thres:
                moving.append(i)
        sel = moving
    if not sel:
        return None

    rng = np.random.RandomState(seed)
    pts_list, ids_list = [], []
    for local_id, i in enumerate(sel):
        collected = []
        for f in range(data.num_frames):
            if not inst.frame_valid[f, i]:
                continue
            pts = data.lidar_points[f]
            if pts.shape[0] == 0:
                continue
            w2o = np.linalg.inv(inst.poses[f, i])
            local = pts @ w2o[:3, :3].T + w2o[:3, 3]
            inside = (np.abs(local) < inst.sizes[i] / 2.0).all(-1)
            collected.append(local[inside])
        if collected:
            allpts = np.concatenate(collected)
            if allpts.shape[0] > max_pts:
                allpts = allpts[rng.choice(allpts.shape[0], max_pts,
                                           replace=False)]
            if allpts.shape[0] == 0:
                allpts = (rng.rand(32, 3).astype(np.float32) - 0.5) \
                    * inst.sizes[i] * 0.8
        else:
            allpts = (rng.rand(32, 3).astype(np.float32) - 0.5) \
                * inst.sizes[i] * 0.8
        pts_list.append(allpts.astype(np.float32))
        ids_list.append(np.full(allpts.shape[0], local_id, np.int64))

    poses = inst.poses[:, sel]                   # (F, I', 4, 4)
    quats = transforms.rotmat_to_quat(
        torch.from_numpy(np.ascontiguousarray(poses[..., :3, :3]))).numpy()
    return {
        "means": np.concatenate(pts_list),
        "point_ids": np.concatenate(ids_list),
        "quats": quats.astype(np.float32),       # (F, I', 4)
        "trans": poses[..., :3, 3].astype(np.float32),
        "frame_valid": inst.frame_valid[:, sel],
        "sizes": inst.sizes[sel],
        "instance_ids": [inst.ids[i] for i in sel],
    }


def get_init_background(data: SceneData, num_samples: int = 800_000,
                        num_near: int = 100_000, num_far: int = 100_000,
                        seed: int = 0, return_times: bool = False):
    """Lidar samples outside instance boxes + near/far random sphere points
    (driving_dataset.py:496-574 + omnire_ms_bilateral.yaml:75-80), drawn
    from np.random.RandomState(seed) as in the JAX package.

    With return_times, also returns each point's normalized observation time
    (the source frame's time for lidar points, 0 for sphere points)."""
    rng = np.random.RandomState(seed)
    frames_with_pts = [(f, p) for f, p in enumerate(data.lidar_points)
                       if p.shape[0]]
    if frames_with_pts:
        all_pts = np.concatenate([p for _, p in frames_with_pts])
        all_t = np.concatenate([
            np.full(p.shape[0], data.normalized_time(f), np.float32)
            for f, p in frames_with_pts])
    else:
        all_pts = np.zeros((0, 3), np.float32)
        all_t = np.zeros((0,), np.float32)
    if all_pts.shape[0]:
        if data.instances is not None:
            keep = np.ones(all_pts.shape[0], bool)
            inst = data.instances
            # filter points inside any instance box at any frame; each box
            # tests only the points whose x and y lie within its half
            # diagonal (plus 1 cm) of its centre's, the only ones that can
            # lie inside it
            order = np.argsort(all_pts[:, 0], kind="stable")
            xs = all_pts[order, 0].astype(np.float64)
            for f in range(data.num_frames):
                for i in range(len(inst.ids)):
                    if not inst.frame_valid[f, i]:
                        continue
                    reach = np.linalg.norm(inst.sizes[i]) / 2.0 + 0.01
                    cx = inst.poses[f, i, 0, 3]
                    near = order[np.searchsorted(xs, cx - reach):
                                 np.searchsorted(xs, cx + reach, "right")]
                    near = near[np.abs(all_pts[near, 1]
                                       - inst.poses[f, i, 1, 3]) < reach]
                    w2o = np.linalg.inv(inst.poses[f, i])
                    local = all_pts[near] @ w2o[:3, :3].T + w2o[:3, 3]
                    keep[near] &= ~(np.abs(local) < inst.sizes[i] / 2.0
                                    ).all(-1)
            all_pts, all_t = all_pts[keep], all_t[keep]
        if all_pts.shape[0] > num_samples:
            sel = rng.choice(all_pts.shape[0], num_samples, replace=False)
            all_pts, all_t = all_pts[sel], all_t[sel]
    center = data.cam_to_worlds[:, :3, 3].mean(0)
    radius = data.scene_radius()
    near = center + _sphere(rng, num_near, radius * 0.8, radius * 2.0)
    far = center + _sphere(rng, num_far, radius * 2.0, radius * 10.0)
    pts = np.concatenate([all_pts, near, far]).astype(np.float32)
    if not return_times:
        return pts
    times = np.concatenate(
        [all_t, np.zeros(near.shape[0] + far.shape[0], np.float32)])
    return pts, times


def _sphere(rng, n, rmin, rmax):
    d = rng.randn(n, 3)
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
    r = (rng.rand(n, 1) * (rmax ** 3 - rmin ** 3) + rmin ** 3) ** (1 / 3)
    return (d * r).astype(np.float32)


def lidar_colors_for_points(data: SceneData, points: np.ndarray,
                            default=0.5) -> np.ndarray:
    """Project init points into the first image that sees them to sample
    colors (driving_dataset lidar coloring, simplified)."""
    colors = np.full((points.shape[0], 3), default, np.float32)
    remaining = np.ones(points.shape[0], bool)
    for i in range(min(data.num_images, 20)):
        if not remaining.any():
            break
        w2c = np.linalg.inv(data.cam_to_worlds[i])
        p = points @ w2c[:3, :3].T + w2c[:3, 3]
        z = p[:, 2]
        K = data.intrinsics[i]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = (p[:, 0] / z * K[0, 0] + K[0, 2]).astype(np.int64)
            v = (p[:, 1] / z * K[1, 1] + K[1, 2]).astype(np.int64)
        ok = (z > 0.5) & (u >= 0) & (u < data.width) & (v >= 0) & \
            (v < data.height) & remaining
        colors[ok] = data.images[i][v[ok], u[ok]]
        remaining &= ~ok
    return colors
