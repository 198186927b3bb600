"""Per-camera ego-vehicle mask assets (port of
bilateral_driving_tpu/preprocess/ego_masks.py; host-side, PIL).

The reference bundles hand-made ego-body masks per dataset
(`project/data/ego_masks/{nuscenes,pandaset,nuplan,argoverse}/<cam>.png`,
consumed at `pixel_source.py:261-281`) so pixels showing the ego car's own
hood/body are excluded from every loss. Those PNGs are data assets this
framework does not copy; instead:

  * `write_placeholders` drops all-zero masks + a README into
    `<scene>/ego_masks/` at convert time, so the asset path exists, the
    loader's code path is exercised, and the README tells the user exactly
    what to put there;
  * `import_masks` ingests a user-supplied mask directory (their own
    drawings, or the reference checkout's `data/ego_masks/<dataset>`)
    into a scene, resizing to the scene's native camera resolution;
  * `data.scene.load_scene` warns loudly when a dataset the reference
    masks (NEEDS_EGO_MASKS) trains without real ones — a placeholder or
    absent mask means ego-car pixels silently enter the rgb/ssim losses.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
from PIL import Image

# datasets whose shipped reference configs rely on bundled ego masks
# (waymo/kitti publish imagery without ego-body intrusion)
NEEDS_EGO_MASKS = ("nuscenes", "pandaset", "nuplan", "argoverse")

README = """\
Ego-vehicle masks (one grayscale PNG per camera index: 0.png, 1.png, ...).

Nonzero pixels mark the ego car's own body/hood and are excluded from all
losses. The files currently here are ALL-ZERO PLACEHOLDERS written at
convert time — replace them with real masks (draw once per camera rig;
they are scene-independent) or import a mask set with:

    python -m bilateral_driving_tpu_torch.preprocess.cli ... \\
        --ego_mask_source /path/to/ego_masks/<dataset>

Training with placeholders on {datasets} lets ego-car pixels into the
rgb/ssim losses (the loader logs a warning).
""".format(datasets=", ".join(NEEDS_EGO_MASKS))


def scene_mask_dir(scene_dir: str) -> str:
    return os.path.join(scene_dir, "ego_masks")


def is_placeholder(path: str) -> bool:
    """True for the all-zero masks write_placeholders emits."""
    with Image.open(path) as im:
        return not np.asarray(im.convert("L")).any()


def write_placeholders(scene_dir: str, cameras: Iterable[int],
                       sizes: Dict[int, Tuple[int, int]]) -> str:
    """All-zero per-camera masks + README under `<scene>/ego_masks/`.
    `sizes[cam]` is (width, height). Existing files are left untouched."""
    out = scene_mask_dir(scene_dir)
    os.makedirs(out, exist_ok=True)
    for cam in cameras:
        p = os.path.join(out, f"{cam}.png")
        if not os.path.exists(p):
            w, h = sizes[cam]
            Image.fromarray(np.zeros((h, w), np.uint8)).save(p)
    with open(os.path.join(out, "README.txt"), "w") as f:
        f.write(README)
    return out


def import_masks(src_dir: str, scene_dir: str, cameras: Iterable[int],
                 sizes: Optional[Dict[int, Tuple[int, int]]] = None) -> int:
    """Copy `<src_dir>/<cam>.png` masks into the scene, resizing to the
    scene's native resolution (the loader resizes again after undistortion,
    pixel_source.py:268-275). Returns the number imported."""
    out = scene_mask_dir(scene_dir)
    os.makedirs(out, exist_ok=True)
    n = 0
    for cam in cameras:
        src = os.path.join(src_dir, f"{cam}.png")
        if not os.path.exists(src):
            continue
        with Image.open(src) as im:
            m = im.convert("L")
            if sizes is not None and cam in sizes:
                m = m.resize(sizes[cam], Image.BILINEAR)
            m.save(os.path.join(out, f"{cam}.png"))
        n += 1
    return n
