"""Rendering CLI: port of bilateral_driving_tpu/tools/render.py.

    python -m bilateral_driving_tpu_torch.tools.render \
        --log_dir work_dirs/myrun [--checkpoint path] \
        [--traj front_center_interp|s_curve|three_key_poses] [--frames 60] \
        [--skip_splits] [--device cpu] [key=value ...]

Rebuilds the scene and trainer from the run's saved config.json (with any
overrides), restores the latest checkpoint (or the given one) and writes,
under `<log_dir>/videos/`, the test and full splits (rgb and depth) and a
novel trajectory through the training cameras (utils/trajectory.py), as
PNG frames: `<name>/0000.png, 0001.png, ...` for each of test, test_depth,
full, full_depth and novel_<traj> (render_loop.save_video). A novel frame
renders through trainer.forward with novel_view and in_test_set on (no
camera refinement, image 0's appearance), with the per-pixel view
directions of its own pose. `videos/render_summary.json` holds the frame
counts, each novel frame's milliseconds (host clock, synchronized) and
the kernel launches of each novel frame.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..eval import render_loop
from ..train import checkpoint
from ..utils import config as config_lib, trajectory
from ..utils.logging import logger, setup_logging
from . import train as train_cli, viewer


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log_dir", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--traj", default="front_center_interp",
                   choices=sorted(trajectory.TRAJECTORY_GENERATORS))
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--skip_splits", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs="*")
    args = p.parse_args(argv)
    dev = train_cli.device_of(args.device)

    setup_logging(args.log_dir)
    cfg = config_lib.load_config(os.path.join(args.log_dir, "config.json"),
                                 overrides=args.opts)
    tcfg, data, statics, state = train_cli.build(cfg, 0, dev)
    ckpt = args.checkpoint or checkpoint.latest_checkpoint(
        os.path.join(args.log_dir, "checkpoints"))
    if ckpt:
        state, extra = checkpoint.restore_checkpoint(ckpt, state)
        tcfg = dataclasses.replace(tcfg,
                                   isect_capacity=extra["isect_capacity"])
        logger.info(f"restored {ckpt} @ step {state.step}")

    out_dir = os.path.join(args.log_dir, "videos")
    test_stride = cfg.get_path("data.test_image_stride", 10)
    neighbor_map = data.neighbor_train_indices(test_stride)
    summary = {"checkpoint": ckpt, "step": int(state.step), "splits": {}}

    if not args.skip_splits:
        _, test_idx = data.split_train_test(test_stride)
        for split, indices in [("test", test_idx),
                               ("full", np.arange(data.num_images))]:
            if len(indices) == 0:
                continue
            res = render_loop.render_images(
                tcfg, state, statics, data, indices,
                neighbor_map=neighbor_map)
            render_loop.save_video([_np(x) for x in res["rgbs"]],
                                   os.path.join(out_dir, f"{split}.mp4"))
            depth_vis = [render_loop.depth_visualizer(_np(d),
                                                      tcfg.max_depth)
                         for d in res["depths"]]
            render_loop.save_video(depth_vis, os.path.join(
                out_dir, f"{split}_depth.mp4"))
            summary["splits"][split] = len(indices)
            logger.info(f"wrote {split} frames ({len(indices)})")

    # novel trajectory: no camera refinement (base.py:325-329), the sky
    # from view directions of each novel pose (pixel_source.py:1070)
    per_cam = {ci: data.cam_to_worlds[data.cam_of_image == ci]
               for ci in range(data.num_cams)}
    traj = trajectory.get_novel_trajectory(per_cam, args.traj, args.frames)
    base_batch = data.get_batch(0)
    h, w = base_batch["pixels"].shape[:2]
    render = viewer.novel_view_renderer(lambda: (tcfg, state), statics,
                                        base_batch)
    frames, frame_ms, frame_launches = [], [], []
    for c2w in traj:
        before = train_cli.launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        rgb = render(c2w, base_batch["normed_time"])
        _sync(dev)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        after = train_cli.launch_counts()
        frame_launches.append({k: after[k] - before[k] for k in after})
        frames.append(_np(rgb))
    novel = render_loop.save_video(frames, os.path.join(
        out_dir, f"novel_{args.traj}.mp4"))
    logger.info(f"wrote novel trajectory frames ({len(frames)}) to {novel}")
    summary.update({
        "traj": args.traj, "novel_frames": len(frames),
        "novel_ms": frame_ms,
        "novel_ms_median": float(np.median(frame_ms)) if frame_ms else None,
        "novel_launches": frame_launches,
        "novel_finite": bool(all(np.isfinite(f).all() for f in frames)),
        "size": [int(h), int(w)], "device": str(dev)})
    with open(os.path.join(out_dir, "render_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
