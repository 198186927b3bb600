"""Decode a drivestudio scene's images and masks into one pixel pack.

    python -m bilateral_driving_tpu_torch.tools.pack_scene \
        tests/fixtures/proto_scene tests/fixtures/proto_scene_pixels.npz

The pack is a compressed .npz holding, under each file's path relative to
the scene directory, what data.scene.load_scene decodes from it with PIL:
`images/*.jpg` as (H, W, 3) uint8 RGB, the PNG masks under `sky_masks/`,
`dynamic_masks/` and `fine_dynamic_masks/` as (H, W) uint8 L. load_scene
with `pixel_pack=` (the config's `data.pixel_pack`) then reads pixels
without PIL, e.g. on a machine that has none. Run where PIL is installed.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

MASK_DIRS = ("sky_masks", "dynamic_masks", "fine_dynamic_masks")


def pack_entries(scene_dir: str) -> dict:
    """Relative path -> decoded uint8 array, for every image and mask."""
    from PIL import Image

    out = {}
    for top, mode, ext in [("images", "RGB", ".jpg")] + [
            (d, "L", ".png") for d in MASK_DIRS]:
        base = os.path.join(scene_dir, top)
        for root, _, files in sorted(os.walk(base)):
            for name in sorted(files):
                if name.endswith(ext):
                    path = os.path.join(root, name)
                    rel = os.path.relpath(path, scene_dir)
                    out[rel] = np.asarray(Image.open(path).convert(mode))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scene_dir")
    p.add_argument("out")
    args = p.parse_args(argv)
    entries = pack_entries(args.scene_dir)
    np.savez_compressed(args.out, **entries)
    raw = sum(a.nbytes for a in entries.values())
    print(f"{args.out}: {len(entries)} arrays, {raw} bytes decoded, "
          f"{os.path.getsize(args.out)} bytes packed")


if __name__ == "__main__":
    main()
