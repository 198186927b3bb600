"""Offline preprocessing dispatcher (reference datasets/preprocess.py:20-29;
port of bilateral_driving_tpu/preprocess/cli.py).

    python -m bilateral_driving_tpu_torch.preprocess.cli \
        --dataset nuscenes --data_root /data/nuscenes --version v1.0-mini \
        --target_dir ./data/nuscenes/processed_10hz \
        --scene_ids 0 1 2 \
        --process_keys images calib lidar dynamic_masks objects \
        [--device cpu]

Separate stages (as in the reference):
    --process_keys sky_masks   runs SegFormer over already-converted scenes
    --process_keys humanpose   matches external 4D-Humans/PHALP track pkls
                               (humanpose/<cam>.pkl) to GT pedestrian tracks
                               and writes humanpose/smpl.pkl (smpl_track.py;
                               the monocular predictor itself needs external
                               checkpoints and runs offline)

`--device` (default cuda; no fallback) is where the nuScenes dynamic masks
are filled, Waymo's lidar points and mask projections are formed and
SegFormer runs; `--checkpoint` names a local SegFormer directory
(preprocess/masks.py). Each stage prints its seconds as
`stage <name>: <s> s`.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="nuscenes",
                   choices=["nuscenes", "waymo", "kitti", "pandaset",
                            "argoverse", "nuplan"])
    p.add_argument("--data_root", required=True)
    p.add_argument("--target_dir", required=True)
    p.add_argument("--version", default="v1.0-mini",
                   help="nuScenes table version (v1.0-mini/v1.0-trainval)")
    p.add_argument("--scene_ids", type=int, nargs="+", default=[0])
    p.add_argument("--scene_names", nargs="+", default=None,
                   help="scene names for name-keyed datasets (kitti drive "
                        "names, pandaset sequence ids); overrides scene_ids")
    p.add_argument("--process_keys", nargs="+",
                   default=["images", "calib", "lidar", "dynamic_masks",
                            "objects"])
    p.add_argument("--checkpoint", default=None,
                   help="SegFormer checkpoint for sky_masks")
    p.add_argument("--ego_mask_source", default=None,
                   help="directory of per-camera ego-vehicle masks "
                        "(<cam>.png) to import into each converted scene; "
                        "without it, all-zero placeholders + a README are "
                        "written (preprocess/ego_masks.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the dynamic-mask fill, Waymo's "
                        "lidar and SegFormer (default cuda)")
    return p.parse_args(argv)


def _stage(name: str, t0: float) -> None:
    print(f"stage {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def main(argv=None):
    args = parse_args(argv)
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    keys = set(args.process_keys)
    convert_keys = keys - {"sky_masks", "humanpose"}

    outputs = []
    t0 = time.perf_counter()
    if convert_keys:
        if args.dataset == "nuscenes":
            from . import nuscenes as nsc

            conv = nsc.NuScenesConverter(
                args.data_root, args.target_dir, version=args.version,
                process_keys=convert_keys, device=dev)
            for sid in args.scene_ids:
                out = conv.convert_scene(sid)
                outputs.append(out)
                print(f"scene {sid} -> {out}")
        elif args.dataset == "waymo":
            from . import waymo as wy

            for sid in args.scene_ids:
                out = wy.convert_scene(args.data_root, args.target_dir, sid,
                                       process_keys=convert_keys, device=dev)
                outputs.append(out)
                print(f"scene {sid} -> {out}")
        elif args.dataset == "kitti":
            from . import kitti as kt

            conv = kt.KittiConverter(args.data_root, args.target_dir,
                                     process_keys=convert_keys)
            names = args.scene_names or [str(s) for s in args.scene_ids]
            for i, name in enumerate(names):
                out = conv.convert_scene(name, out_name=f"{i:03d}")
                outputs.append(out)
                print(f"scene {name} -> {out}")
        elif args.dataset == "pandaset":
            from . import pandaset as pd_

            conv = pd_.PandasetConverter(args.data_root, args.target_dir,
                                         process_keys=convert_keys)
            names = args.scene_names or [f"{s:03d}" for s in args.scene_ids]
            for i, name in enumerate(names):
                out = conv.convert_scene(name, out_name=f"{i:03d}")
                outputs.append(out)
                print(f"scene {name} -> {out}")
        elif args.dataset == "argoverse":
            from . import argoverse as av

            conv = av.ArgoverseConverter(args.data_root, args.target_dir,
                                         process_keys=convert_keys)
            names = args.scene_names or [str(s) for s in args.scene_ids]
            for i, name in enumerate(names):
                out = conv.convert_scene(name, out_name=f"{i:03d}")
                outputs.append(out)
                print(f"scene {name} -> {out}")
        else:
            from . import nuplan as npl

            conv = npl.NuplanConverter(args.data_root, args.target_dir,
                                       process_keys=convert_keys)
            names = args.scene_names or [str(s) for s in args.scene_ids]
            for i, name in enumerate(names):
                out = conv.convert_scene(name, out_name=f"{i:03d}")
                outputs.append(out)
                print(f"scene {name} -> {out}")

        _stage("convert", t0)

    if outputs:
        t0 = time.perf_counter()
        # ego-vehicle mask assets per converted scene: import the user's
        # set or write documented placeholders (preprocess/ego_masks.py;
        # reference bundles these at data/ego_masks/<dataset>/<cam>.png)
        import os

        from PIL import Image

        from . import ego_masks as em

        for out in outputs:
            img_dir = os.path.join(out, "images")
            if not os.path.isdir(img_dir):
                continue
            cams = sorted({
                int(f.rsplit("_", 1)[1].split(".")[0])
                for f in os.listdir(img_dir) if "_" in f})
            sizes = {}
            for cam in cams:
                first = sorted(f for f in os.listdir(img_dir)
                               if f.endswith(f"_{cam}.jpg")
                               or f.endswith(f"_{cam}.png"))[0]
                with Image.open(os.path.join(img_dir, first)) as im:
                    sizes[cam] = im.size
            if args.ego_mask_source:
                n = em.import_masks(args.ego_mask_source, out, cams, sizes)
                print(f"ego masks: imported {n} -> {em.scene_mask_dir(out)}")
            else:
                d = em.write_placeholders(out, cams, sizes)
                print(f"ego masks: placeholders at {d} "
                      f"(replace with real masks; see README.txt)")
        _stage("ego_masks", t0)

    if "sky_masks" in keys:
        t0 = time.perf_counter()
        from . import masks

        kw = {"checkpoint": args.checkpoint} if args.checkpoint else {}
        mp = masks.load_segmenter(device=dev, **kw)
        import os

        targets = outputs or [
            os.path.join(args.target_dir, f"{sid:03d}")
            for sid in args.scene_ids]
        for out in targets:
            n = masks.extract_scene_masks(out, model_proc=mp)
            print(f"sky masks: {n} images in {out}")
        _stage("sky_masks", t0)

    if "humanpose" in keys:
        t0 = time.perf_counter()
        import os

        from PIL import Image

        from . import smpl_track

        targets = outputs or [
            os.path.join(args.target_dir, f"{sid:03d}")
            for sid in args.scene_ids]
        for out in targets:
            cams = sorted({
                int(f.split(".")[0])
                for f in os.listdir(os.path.join(out, "intrinsics"))})
            sizes = {}
            for cam in cams:
                img_dir = os.path.join(out, "images")
                first = sorted(f for f in os.listdir(img_dir)
                               if f.endswith(f"_{cam}.jpg")
                               or f.endswith(f"_{cam}.png"))[0]
                with Image.open(os.path.join(img_dir, first)) as im:
                    sizes[cam] = im.size
            # frame count from the scene's per-camera extrinsics (what
            # load_scene does) — NOT the GT annotation span: tracker pkls
            # have one entry per VIDEO frame, and a scene with no annotated
            # pedestrians still has frames
            num_frames = len([
                f for f in os.listdir(os.path.join(out, "extrinsics"))
                if f.endswith(f"_{cams[0]}.txt")])
            if num_frames == 0:
                # ego_pose-style layouts (kitti/waymo/argoverse) keep static
                # per-camera extrinsics; frames live in ego_pose/
                num_frames = len(os.listdir(os.path.join(out, "ego_pose")))
            gt = smpl_track.gt_tracks_from_scene(out, cams, sizes,
                                                 num_frames=num_frames)
            path = smpl_track.process_scene(out, gt, num_frames)
            print(f"humanpose: {path}")
        _stage("humanpose", t0)


if __name__ == "__main__":
    main()
