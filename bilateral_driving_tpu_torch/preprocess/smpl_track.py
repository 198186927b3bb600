"""SMPL pedestrian-track postprocessing: predicted tracks ->
humanpose/smpl.pkl.

Port of bilateral_driving_tpu/preprocess/smpl_track.py, the equivalent of
the reference's 4D-Humans postprocessing stage
(reference datasets/tools/postprocess.py:103-601 `match_and_postprocess` and
the humanpose_process.py driver): per-camera human pose tracks predicted by a
monocular tracker (4D-Humans/PHALP in the reference) are matched to the
dataset's ground-truth pedestrian tracks by 2-D box IoU, missing frames are
interpolated (slerp for rotations), and the per-camera estimates are merged —
largest detection area wins — into one `humanpose/smpl.pkl` keyed by GT
instance id, exactly the schema `data/scene.py:load_smpl_poses` consumes.

The *predictor* itself (an HMR transformer with external checkpoints,
reference datasets/tools/extract_smpl.py:27-60) is not re-implemented — no
checkpoints or raw video exist in this environment. `run_tracker` is the
gated hook: point it at any per-camera track pkl in the 4D-Humans layout
(frame -> {"tid", "bbox", "tracked_time", "smpl", "camera"}) and the rest of
the pipeline is pure numpy and fully tested.

Everything here is host-side preprocessing: plain numpy, no torch.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

NUM_BODY_JOINTS = 23


# --------------------------------------------------------------------------
# small geometry helpers
# --------------------------------------------------------------------------


def iou_xywh(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two [x, y, w, h] boxes (reference postprocess.py:38-50)."""
    ax0, ay0, aw, ah = a
    bx0, by0, bw, bh = b
    ix = max(0.0, min(ax0 + aw, bx0 + bw) - max(ax0, bx0))
    iy = max(0.0, min(ay0 + ah, by0 + bh) - max(ay0, by0))
    inter = ix * iy
    union = aw * ah + bw * bh - inter
    return float(inter / union) if union > 0 else 0.0


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) wxyz, numerically safe (Shepperd)."""
    m = np.asarray(m, np.float64)
    w = np.sqrt(np.maximum(0.0, 1.0 + m[..., 0, 0] + m[..., 1, 1]
                           + m[..., 2, 2])) / 2.0
    x = np.sqrt(np.maximum(0.0, 1.0 + m[..., 0, 0] - m[..., 1, 1]
                           - m[..., 2, 2])) / 2.0
    y = np.sqrt(np.maximum(0.0, 1.0 - m[..., 0, 0] + m[..., 1, 1]
                           - m[..., 2, 2])) / 2.0
    z = np.sqrt(np.maximum(0.0, 1.0 - m[..., 0, 0] - m[..., 1, 1]
                           + m[..., 2, 2])) / 2.0
    x = np.copysign(x, m[..., 2, 1] - m[..., 1, 2])
    y = np.copysign(y, m[..., 0, 2] - m[..., 2, 0])
    z = np.copysign(z, m[..., 1, 0] - m[..., 0, 1])
    q = np.stack([w, x, y, z], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def slerp_mats(m0: np.ndarray, m1: np.ndarray, frac: float) -> np.ndarray:
    """Slerp between stacks of rotation matrices (postprocess.py:8-36)."""
    q0, q1 = _mat_to_quat(m0), _mat_to_quat(m1)
    dot = np.clip((q0 * q1).sum(-1), -1.0, 1.0)
    q1 = np.where(dot[..., None] < 0, -q1, q1)
    dot = np.abs(dot)
    theta0 = np.arccos(np.clip(dot, -1.0, 1.0))
    sin0 = np.sin(theta0)
    safe = dot <= 0.9995
    s0 = np.where(safe, np.cos(theta0 * frac)
                  - dot * np.sin(theta0 * frac) / np.where(safe, sin0, 1.0),
                  1.0 - frac)
    s1 = np.where(safe, np.sin(theta0 * frac) / np.where(safe, sin0, 1.0),
                  frac)
    q = s0[..., None] * q0 + s1[..., None] * q1
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return _quat_to_mat(q).astype(np.float64)


def interpolate_gaps(valid: np.ndarray, values: np.ndarray,
                     rotations: bool = False) -> np.ndarray:
    """Fill frames where `valid` is False from the nearest valid neighbors
    (linear, or slerp for (...,3,3) rotation stacks); edges clamp
    (postprocess.py:53-79)."""
    values = np.array(values, np.float64, copy=True)
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return values
    for i in np.flatnonzero(~np.asarray(valid, bool)):
        p = idx[idx < i]
        n = idx[idx > i]
        if p.size and n.size:
            lo, hi = p[-1], n[0]
            frac = (i - lo) / (hi - lo)
            if rotations:
                values[i] = slerp_mats(values[lo], values[hi], frac)
            else:
                values[i] = (1 - frac) * values[lo] + frac * values[hi]
        elif p.size:
            values[i] = values[p[-1]]
        else:
            values[i] = values[n[0]]
    return values


# --------------------------------------------------------------------------
# track containers
# --------------------------------------------------------------------------


@dataclass
class Track:
    """One track (predicted or GT) on one camera over F frames."""
    valid: np.ndarray                      # (F,) bool
    bbox: np.ndarray                       # (F, 4) xywh
    global_orient: Optional[np.ndarray] = None   # (F, 1, 3, 3)
    body_pose: Optional[np.ndarray] = None       # (F, 23, 3, 3)
    betas: Optional[np.ndarray] = None           # (F, 10)
    camera: Optional[np.ndarray] = None          # (F, 3) weak-persp params

    @staticmethod
    def empty(num_frames: int, with_smpl: bool) -> "Track":
        t = Track(valid=np.zeros(num_frames, bool),
                  bbox=np.zeros((num_frames, 4), np.float64))
        if with_smpl:
            t.global_orient = np.tile(np.eye(3), (num_frames, 1, 1, 1))
            t.body_pose = np.tile(np.eye(3),
                                  (num_frames, NUM_BODY_JOINTS, 1, 1))
            t.betas = np.zeros((num_frames, 10))
            t.camera = np.zeros((num_frames, 3))
        return t


def parse_phalp_tracks(raw: Dict, num_frames: int,
                       with_smpl: bool) -> Dict[int, Track]:
    """4D-Humans/PHALP per-frame dict -> per-tid Track
    (postprocess.py:147-182). `raw` maps frame key -> {"tid", "bbox",
    "tracked_time", "smpl", "camera"} (pred) or
    {"extra_data": {"gt_track_id"}, "gt_bbox"} (GT)."""
    tracks: Dict[int, Track] = {}
    for fi, frame in enumerate(raw.values()):
        if "extra_data" in frame:
            tids = frame["extra_data"]["gt_track_id"]
            boxes = frame["gt_bbox"]
            for i, tid in enumerate(tids):
                tr = tracks.setdefault(tid, Track.empty(num_frames, False))
                tr.valid[fi] = True
                tr.bbox[fi] = np.asarray(boxes[i], np.float64)
            continue
        for i, tid in enumerate(frame["tid"]):
            # tracked_time > 0 marks coasted (not re-detected) frames
            if frame.get("tracked_time", [0] * len(frame["tid"]))[i] != 0:
                continue
            tr = tracks.setdefault(tid, Track.empty(num_frames, with_smpl))
            tr.valid[fi] = True
            tr.bbox[fi] = np.asarray(frame["bbox"][i], np.float64)
            if with_smpl:
                s = frame["smpl"][i]
                tr.global_orient[fi] = np.asarray(
                    s["global_orient"]).reshape(1, 3, 3)
                tr.body_pose[fi] = np.asarray(
                    s["body_pose"]).reshape(NUM_BODY_JOINTS, 3, 3)
                tr.betas[fi] = np.asarray(s["betas"]).reshape(-1)[:10]
                tr.camera[fi] = np.asarray(frame["camera"][i]).reshape(-1)[:3]
    return tracks


def _track_iou(a: Track, b: Track) -> float:
    """Mean-over-frames IoU on co-valid frames (postprocess.py:205-215)."""
    both = a.valid & b.valid
    if not both.any():
        return 0.0
    s = sum(iou_xywh(a.bbox[fi], b.bbox[fi]) for fi in np.flatnonzero(both))
    return s / a.valid.shape[0]


def match_tracks(pred: Dict[int, Track],
                 gt: Dict[int, Track]) -> Dict[int, int]:
    """GT tid -> best predicted tid by mean-over-frames IoU; -1 when nothing
    overlaps (the gt->pred pass, postprocess.py:229-266)."""
    out = {}
    for gt_tid, gt_tr in gt.items():
        best, best_iou = -1, 0.0
        for pred_tid, pr in pred.items():
            v = _track_iou(pr, gt_tr)
            if v > best_iou:
                best, best_iou = pred_tid, v
        out[gt_tid] = best
    return out


def valid_gt_tids(pred_by_cam: Dict[int, Dict[int, Track]],
                  gt_by_cam: Dict[int, Dict[int, Track]]) -> set:
    """GT tids that are some predicted track's BEST match in any camera
    (the pred->gt prefilter, postprocess.py:185-227).

    Without this pass, a GT track with any nonzero IoU against some
    prediction would get linked even when that prediction's best match is a
    different GT — two overlapping pedestrians could both receive the same
    predicted pose track."""
    valid = set()
    for cam, preds in pred_by_cam.items():
        gts = gt_by_cam.get(cam, {})
        for pred_tid, pr in preds.items():
            best, best_iou = None, 0.0
            for gt_tid, gt_tr in gts.items():
                v = _track_iou(pr, gt_tr)
                if v > best_iou:
                    best, best_iou = gt_tid, v
            if best is not None:
                valid.add(best)
    return valid


def detect_breaks_mask(must: np.ndarray) -> np.ndarray:
    """Interior visibility gaps to back-fill (postprocess.py:79-101).

    Marks every False run that lies strictly between two True frames —
    except, mirroring the reference's quirk, a gap whose terminating True
    is the final frame is left unfilled."""
    must = np.asarray(must, bool)
    n = must.shape[0]
    fill = np.zeros(n, bool)
    last_true = -1
    in_gap = False
    for i, v in enumerate(must):
        if v:
            if in_gap and last_true != -1 and i < n - 1:
                fill[last_true + 1:i] = True
            in_gap = False
            last_true = i
        elif last_true != -1:
            in_gap = True
    return fill


# --------------------------------------------------------------------------
# per-camera collection + cross-camera merge
# --------------------------------------------------------------------------


@dataclass
class MergedTrack:
    """Final per-instance record — the smpl.pkl value schema
    (consumed by data/scene.py:load_smpl_poses; produced at
    postprocess.py:440-520)."""
    valid_mask: np.ndarray          # (F,) bool
    selected_cam_idx: np.ndarray    # (F,) int
    smpl: Dict[str, np.ndarray] = field(default_factory=dict)


def merge_cameras(gt_by_cam: Dict[int, Dict[int, Track]],
                  pred_by_cam: Dict[int, Dict[int, Track]],
                  num_frames: int) -> Dict[int, MergedTrack]:
    """Match per camera, fill per-camera gaps, then pick — per frame — the
    camera with the largest GT-box area among those with a matched estimate;
    finally interpolate frames no camera could pose."""
    cams = sorted(gt_by_cam.keys())
    keep = valid_gt_tids(pred_by_cam, gt_by_cam)
    gt_tids = sorted({t for c in cams for t in gt_by_cam[c]} & keep)
    merged: Dict[int, MergedTrack] = {}
    for gt_tid in gt_tids:
        nc = len(cams)
        orient = np.tile(np.eye(3), (nc, num_frames, 1, 1, 1))
        body = np.tile(np.eye(3), (nc, num_frames, NUM_BODY_JOINTS, 1, 1))
        betas = np.zeros((nc, num_frames, 10))
        area = np.zeros((nc, num_frames))
        matched = np.zeros((nc, num_frames), bool)
        appear = np.zeros((nc, num_frames), bool)
        for ci, cam in enumerate(cams):
            gt_tr = gt_by_cam[cam].get(gt_tid)
            if gt_tr is None:
                continue
            appear[ci] = gt_tr.valid
            area[ci] = gt_tr.bbox[:, 2] * gt_tr.bbox[:, 3] * gt_tr.valid
            pred_tid = match_tracks(pred_by_cam.get(cam, {}),
                                    {gt_tid: gt_tr})[gt_tid]
            if pred_tid < 0:
                continue
            pr = pred_by_cam[cam][pred_tid]
            m = gt_tr.valid & pr.valid
            if not m.any():
                continue
            # complete this camera's estimate onto every frame the GT box
            # appears (occlusion / detector-miss fill, postprocess.py:378-416)
            o = interpolate_gaps(m, pr.global_orient, rotations=True)
            b = interpolate_gaps(m, pr.body_pose, rotations=True)
            be = interpolate_gaps(m, pr.betas)
            fill = gt_tr.valid
            orient[ci][fill] = o[fill]
            body[ci][fill] = b[fill]
            betas[ci][fill] = be[fill]
            matched[ci] = fill
        any_match = matched.any(0)
        if not any_match.any():
            continue
        # largest-area camera among matched ones per frame
        area_m = np.where(matched, area, -1.0)
        best_cam = area_m.argmax(0)
        f = np.arange(num_frames)
        rec = MergedTrack(
            valid_mask=np.zeros(num_frames, bool),
            selected_cam_idx=np.full(num_frames, -1, np.int64),
            smpl={
                "global_orient": np.tile(np.eye(3),
                                         (num_frames, 1, 1, 1)),
                "body_pose": np.tile(np.eye(3),
                                     (num_frames, NUM_BODY_JOINTS, 1, 1)),
                "betas": np.zeros((num_frames, 10)),
            })
        rec.smpl["global_orient"][any_match] = orient[
            best_cam[any_match], f[any_match]]
        rec.smpl["body_pose"][any_match] = body[
            best_cam[any_match], f[any_match]]
        rec.smpl["betas"][any_match] = betas[best_cam[any_match],
                                             f[any_match]]
        rec.selected_cam_idx[any_match] = np.asarray(
            [cams[c] for c in best_cam[any_match]])
        # frames where the GT box appears somewhere but no camera matched:
        # interpolate the merged sequence (postprocess.py:494-520)
        must = appear.any(0)
        need = must & ~any_match
        if need.any():
            rec.smpl["global_orient"] = interpolate_gaps(
                any_match, rec.smpl["global_orient"], rotations=True)
            rec.smpl["body_pose"] = interpolate_gaps(
                any_match, rec.smpl["body_pose"], rotations=True)
            rec.smpl["betas"] = interpolate_gaps(any_match,
                                                 rec.smpl["betas"])
            prev = np.maximum.accumulate(
                np.where(any_match, np.arange(num_frames), -1))
            prev = np.where(prev < 0, int(np.flatnonzero(any_match)[0]),
                            prev)
            rec.selected_cam_idx[need] = rec.selected_cam_idx[prev[need]]
        # back-fill short all-camera visibility BREAKS (postprocess.py:
        # 527-559): interior gaps in `must` become valid with interpolated
        # poses, keeping tracks continuous through brief disappearances
        fill = detect_breaks_mask(must)
        if fill.any():
            rec.smpl["global_orient"] = interpolate_gaps(
                must, rec.smpl["global_orient"], rotations=True)
            rec.smpl["body_pose"] = interpolate_gaps(
                must, rec.smpl["body_pose"], rotations=True)
            rec.smpl["betas"] = interpolate_gaps(must, rec.smpl["betas"])
            cam_f = interpolate_gaps(
                must, rec.selected_cam_idx.astype(np.float64))
            rec.selected_cam_idx[fill] = np.round(cam_f[fill]).astype(
                np.int64)
            must = must | fill
        rec.valid_mask = must
        merged[gt_tid] = rec
    return merged


def write_smpl_pkl(merged: Dict[int, MergedTrack], scene_dir: str) -> str:
    """Serialize to `<scene>/humanpose/smpl.pkl` in the loader's schema."""
    out = {}
    for tid, rec in merged.items():
        out[tid] = {
            "valid_mask": rec.valid_mask,
            "selected_cam_idx": rec.selected_cam_idx,
            "smpl": {
                "global_orient": rec.smpl["global_orient"].astype(
                    np.float32),
                "body_pose": rec.smpl["body_pose"].astype(np.float32),
                "betas": rec.smpl["betas"].astype(np.float32),
            },
        }
    os.makedirs(os.path.join(scene_dir, "humanpose"), exist_ok=True)
    path = os.path.join(scene_dir, "humanpose", "smpl.pkl")
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return path


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------


def _is_smpl_class(cls: str, pedestrian_classes) -> bool:
    """SMPL-track-worthy class: prefix match against the explicit list OR an
    exact SMPLNodes entry in the cross-dataset class table (covers KITTI
    'Pedestrian', PandaSet 'Pedestrian with Object', AV2 'PEDESTRIAN',
    nuPlan 'pedestrian' — the reference's per-dataset *_human_utils.py
    SMPLNODE_CLASSES lists)."""
    from ..data.scene import DEFAULT_CLASS_TO_NODE

    if any(cls.startswith(p) for p in pedestrian_classes):
        return True
    return DEFAULT_CLASS_TO_NODE.get(cls) == "SMPLNodes"


def gt_tracks_from_scene(scene_dir: str, camera_list: List[int],
                         image_size: Dict[int, tuple],
                         pedestrian_classes=("human.pedestrian",),
                         num_frames: Optional[int] = None,
                         dataset: Optional[str] = None) -> Dict:
    """Project pedestrian 3-D boxes of a converted scene to per-camera 2-D
    GT tracks (the reference's per-dataset `*_human_utils.project_human_
    boxes`, dispatched via humanpose_process.py:30-34 — one generic
    implementation here because every converter emits the same layout).

    Handles both calibration styles (data/meta.py): per-frame cam-to-world
    extrinsics (nuscenes/pandaset) and static cam-to-ego + per-frame
    ego_pose (waymo/kitti/argoverse/nuplan), including the dataset->OpenCV
    axis permutation. Returns {cam: {frame: gt_frame_dict}} in the raw
    schema `parse_phalp_tracks` expects."""
    import json

    from ..data import meta as meta_mod

    layout = meta_mod.get_layout(dataset)
    opencv_m = layout.opencv_mat() if layout is not None else np.eye(4)

    with open(os.path.join(scene_dir, "instances",
                           "instances_info.json")) as f:
        info = json.load(f)
    if num_frames is None:
        frames = sorted({fi for meta in info.values()
                         for fi in meta["frame_annotations"]["frame_idx"]})
        num_frames = (frames[-1] + 1) if frames else 0
    out = {}
    for cam in camera_list:
        K = np.loadtxt(os.path.join(scene_dir, "intrinsics", f"{cam}.txt"))
        if K.size == 9 and K.ndim == 2:
            K = K.reshape(3, 3)
        else:  # fx fy cx cy [dist...]
            fx, fy, cx, cy = K.reshape(-1)[:4]
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        w, h = image_size[cam]
        static_path = os.path.join(scene_dir, "extrinsics", f"{cam}.txt")
        cam_to_ego = (np.loadtxt(static_path) @ opencv_m
                      if os.path.exists(static_path) else None)
        per_frame = {}
        for fi in range(num_frames):
            tids, boxes = [], []
            if cam_to_ego is not None:
                ego_path = os.path.join(scene_dir, "ego_pose",
                                        f"{fi:03d}.txt")
                if not os.path.exists(ego_path):
                    per_frame[fi] = _gt_raw_frame(tids, boxes)
                    continue
                c2w = np.loadtxt(ego_path) @ cam_to_ego
            else:
                c2w_path = os.path.join(scene_dir, "extrinsics",
                                        f"{fi:03d}_{cam}.txt")
                if not os.path.exists(c2w_path):
                    per_frame[fi] = _gt_raw_frame(tids, boxes)
                    continue
                c2w = np.loadtxt(c2w_path)
            w2c = np.linalg.inv(c2w)
            for iid, meta in info.items():
                cls = meta.get("class_name", "")
                if not _is_smpl_class(cls, pedestrian_classes):
                    continue
                ann = meta["frame_annotations"]
                if fi not in ann["frame_idx"]:
                    continue
                k = ann["frame_idx"].index(fi)
                o2w = np.asarray(ann["obj_to_world"][k], np.float64)
                size = np.asarray(ann["box_size"][k], np.float64)
                box = _box_to_xywh(o2w, size, w2c, K, w, h)
                if box is not None:
                    tids.append(int(iid))
                    boxes.append(box)
            per_frame[fi] = _gt_raw_frame(tids, boxes)
        out[cam] = per_frame
    return out


def _gt_raw_frame(tids, boxes):
    return {"extra_data": {"gt_track_id": tids}, "gt_bbox": boxes}


def _box_to_xywh(o2w, size, w2c, K, width, height):
    """3-D box -> clipped xywh image box; None when off-screen."""
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
    x0 = max(0.0, float(px[:, 0].min()))
    y0 = max(0.0, float(px[:, 1].min()))
    x1 = min(float(width), float(px[:, 0].max()))
    y1 = min(float(height), float(px[:, 1].max()))
    if x1 - x0 < 2.0 or y1 - y0 < 2.0:
        return None
    return np.array([x0, y0, x1 - x0, y1 - y0])


def run_tracker(scene_dir: str, camera_list: List[int], predictor=None):
    """Per-camera predicted human tracks, resolved in precedence order:

    1. `<scene>/humanpose/<cam>.pkl` — a user-provided tracker output (any
       tracker emitting the 4D-Humans frame schema);
    2. the `hmr_predictor.run_4dhumans` wrapper (reference
       extract_smpl.py:196-287): cached `humanpose/temp/phalp_output/
       cam_<cam>.pkl`, else the PHALP+HMR2 predictor — checkpoint-gated;
       its ~2 GB external checkpoints are not bundled (the reference also
       downloads them at runtime), so without the stack installed this
       raises with instructions."""
    from . import hmr_predictor

    preds = {}
    missing = []
    for cam in camera_list:
        path = os.path.join(scene_dir, "humanpose", f"{cam}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                preds[cam] = pickle.load(f)
        else:
            missing.append(cam)
    if missing:
        try:
            preds.update(hmr_predictor.run_4dhumans(
                scene_dir, missing, predictor=predictor))
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"no predicted human tracks for cameras {missing} under "
                f"{scene_dir}/humanpose and the bundled 4D-Humans wrapper "
                f"could not run: {e}") from e
    return preds


def process_scene(scene_dir: str, gt_raw_by_cam: Dict[int, Dict],
                  num_frames: int,
                  pred_raw_by_cam: Optional[Dict[int, Dict]] = None,
                  predictor=None) -> str:
    """Full postprocess for one scene: parse -> match -> merge -> smpl.pkl.
    `predictor` (optional) feeds `run_tracker`'s 4D-Humans wrapper when no
    per-camera pkls exist yet."""
    cams = sorted(gt_raw_by_cam.keys())
    if pred_raw_by_cam is None:
        pred_raw_by_cam = run_tracker(scene_dir, cams, predictor=predictor)
    for c in cams:
        # parse_phalp_tracks enumerates raw frames positionally; a tracker
        # pkl must cover the video exactly (reference match_and_postprocess
        # asserts len(pred) == len(gt) the same way)
        if len(pred_raw_by_cam[c]) != num_frames:
            raise ValueError(
                f"camera {c}: predicted track pkl has "
                f"{len(pred_raw_by_cam[c])} frames, scene has {num_frames}")
    gt = {c: parse_phalp_tracks(gt_raw_by_cam[c], num_frames, False)
          for c in cams}
    pred = {c: parse_phalp_tracks(pred_raw_by_cam[c], num_frames, True)
            for c in cams}
    merged = merge_cameras(gt, pred, num_frames)
    return write_smpl_pkl(merged, scene_dir)
