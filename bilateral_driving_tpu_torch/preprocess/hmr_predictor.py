"""4D-Humans / HMR2 predictor wrapper (reference extract_smpl.py; port of
bilateral_driving_tpu/preprocess/hmr_predictor.py).

The reference extracts monocular human pose by wrapping the PHALP tracker
with an HMR2 transformer head (`datasets/tools/extract_smpl.py:27-60`, the
`HMR2Predictor`/`HMR2023TextureSampler` classes) and orchestrating it per
camera (`run_4DHumans`, extract_smpl.py:196-287): images -> cached video ->
PHALP track() -> per-camera pkl under
`humanpose/temp/phalp_output/cam_{id}.pkl`.

That stack needs ~2 GB of external checkpoints plus the `phalp` /
4D-Humans packages, none of which are bundled (matching the reference,
which also downloads them at runtime). This module reproduces the
*orchestration* so the pipeline runs end-to-end the moment the stack
exists:

  * the same per-camera cache contract (`cam_{id}.pkl`, reused on re-runs,
    extract_smpl.py:208-213);
  * the same image enumeration (`images/*_{cam}.*` sorted,
    extract_smpl.py:222);
  * an injectable `predictor` callable producing frames in the schema
    `smpl_track.parse_phalp_tracks` consumes — tests inject a mock, and
    `default_predictor()` builds the real PHALP+HMR2 tracker when its
    packages are importable.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Callable, Dict, List, Optional

# predictor(image_paths, cam_id) -> {frame_key: {"tid", "bbox",
#   "tracked_time", "smpl", "camera"}} — one entry per video frame, the
# 4D-Humans tracker's native output schema (smpl_track.parse_phalp_tracks)
Predictor = Callable[[List[str], int], Dict]


def frame_paths(scene_dir: str, cam_id: int) -> List[str]:
    """Sorted per-camera image paths (extract_smpl.py:222's glob)."""
    return sorted(glob.glob(os.path.join(scene_dir, "images",
                                         f"*_{cam_id}.*")))


def cache_path(scene_dir: str, cam_id: int) -> str:
    return os.path.join(scene_dir, "humanpose", "temp", "phalp_output",
                        f"cam_{cam_id}.pkl")


def default_predictor() -> Predictor:
    """The real PHALP + HMR2 tracker, gated on its external packages.

    Mirrors extract_smpl.py:27-60: a PHALP tracker whose HMAR head is
    replaced by the HMR2 transformer (checkpoints auto-downloaded by
    4D-Humans' own `download_models`). Raises with instructions when the
    stack is absent — this framework bundles neither the packages nor the
    ~2 GB checkpoints, exactly like the reference repo."""
    try:
        from phalp.configs.base import FullConfig            # noqa: F401
        from phalp.trackers.PHALP import PHALP               # noqa: F401
    except ImportError as e:
        raise FileNotFoundError(
            "the 4D-Humans/PHALP stack is not installed (pip install "
            "phalp + the 4D-Humans repo; checkpoints download on first "
            "run). Either install it, or run any tracker emitting the "
            "same frame schema offline and drop its pkls at "
            "humanpose/<cam>.pkl.") from e

    def predict(image_paths: List[str], cam_id: int) -> Dict:
        # Build the tracker the way extract_smpl.py:269-240 does: a PHALP
        # subclass whose setup_hmr installs the HMR2 head. The video-file
        # intermediary the reference creates (cv2.VideoWriter,
        # extract_smpl.py:217-231) exists only because PHALP's input API
        # wants one; PHALP also accepts an image-directory source, which
        # avoids the re-encode entirely.
        from phalp.trackers.PHALP import PHALP

        class _HMR2Tracker(PHALP):
            def setup_hmr(self):
                from phalp.models.hmar.hmr import HMR2018Predictor

                class _HMR2(HMR2018Predictor):
                    def __init__(self, cfg):
                        super().__init__(cfg)
                        from hmr2.models import download_models, load_hmr2
                        download_models()
                        model, _ = load_hmr2()
                        self.model = model.eval()

                    def forward(self, x):
                        out = self.hmar_old(x)
                        mout = self.model({"img": x[:, :3],
                                           "mask": x[:, 3].clip(0, 1)})
                        out.update(pose_smpl=mout["pred_smpl_params"],
                                   pred_cam=mout["pred_cam"])
                        return out

                self.HMAR = _HMR2(self.cfg)

        from phalp.configs.base import FullConfig

        cfg = FullConfig()
        cfg.video.source = os.path.dirname(image_paths[0])
        out_dir = os.path.join(os.path.dirname(os.path.dirname(
            image_paths[0])), "humanpose", "temp", "phalp_output")
        os.makedirs(out_dir, exist_ok=True)
        cfg.video.output_dir = out_dir
        _HMR2Tracker(cfg).track()
        # PHALP writes its result pkl under <output_dir>/results/
        # (extract_smpl.py:271-277 loads it the same way)
        results = sorted(glob.glob(os.path.join(out_dir, "results",
                                                "*.pkl")))
        import joblib
        return joblib.load(results[-1])

    return predict


def run_4dhumans(scene_dir: str, camera_list: List[int],
                 predictor: Optional[Predictor] = None,
                 save_temp: bool = True) -> Dict[int, Dict]:
    """Per-camera predicted tracks with the reference's cache contract
    (extract_smpl.py:196-287): cached `cam_{id}.pkl` reused, fresh cameras
    run through `predictor` (default: the gated PHALP+HMR2 stack)."""
    if not os.path.isdir(os.path.join(scene_dir, "images")):
        raise FileNotFoundError(
            f"no images/ under {scene_dir}; run the converter first")
    preds: Dict[int, Dict] = {}
    fresh = []
    for cam in camera_list:
        cp = cache_path(scene_dir, cam)
        if os.path.exists(cp):
            with open(cp, "rb") as f:
                preds[cam] = pickle.load(f)
        else:
            fresh.append(cam)
    if fresh:
        pred_fn = predictor or default_predictor()
        for cam in fresh:
            paths = frame_paths(scene_dir, cam)
            if not paths:
                raise FileNotFoundError(
                    f"no images for camera {cam} under {scene_dir}/images")
            raw = pred_fn(paths, cam)
            if save_temp:
                cp = cache_path(scene_dir, cam)
                os.makedirs(os.path.dirname(cp), exist_ok=True)
                with open(cp, "wb") as f:
                    pickle.dump(raw, f)
            preds[cam] = raw
    return preds
