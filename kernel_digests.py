#!/usr/bin/env python3
"""Digests of the render kernels' outputs, to hold two checkouts' kernels
bit for bit.

Builds the flagship scene of chip_smoke.py (the same sizes and seed 0) with
the package of the checkout at --root (this one by default) and its
kernels, renders image 0 once with the expansion's and the compositing
forward's inputs captured, and prints one JSON line of SHA-256 digests: of
those inputs, of the expansion's key, gid and feature bits, of the
forward's image, and of the forward with residuals (image, n_live and the
live chunks' checkpoints). Two checkouts whose kernels give the same bits
on the same inputs print the same line. It uses only the package's entry
points and its kernel wrappers, so it runs on older checkouts too. Needs a
card.

Usage: python3 kernel_digests.py [--root CHECKOUT] [--capacity N]
--capacity is chip_smoke.py's intersection capacity (its scene phase
prints it).
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import sys
import types

# chip_smoke.py's flagship scene
WIDTH, HEIGHT = 533, 300
FOCAL = 1266.0 / 3.0
NUM_FRAMES, NUM_CAMS = 40, 6
NUM_BG, RIGID, DEFORM, PTS = 1_000_000, 16, 8, 4096


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--capacity", type=int, default=1_441_792)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for mod in [m for m in sys.modules if m.startswith("bilateral_driving")]:
        del sys.modules[mod]

    import torch

    configs = importlib.import_module("bilateral_driving_tpu_torch.configs")
    synthetic = importlib.import_module(
        "bilateral_driving_tpu_torch.data.synthetic")
    render_loop = importlib.import_module(
        "bilateral_driving_tpu_torch.eval.render_loop")
    pipeline = importlib.import_module(
        "bilateral_driving_tpu_torch.ops.pipeline")
    expand_cuda, rasterize_cuda = pipeline.expand_cuda, pipeline.rasterize_cuda

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    scene = synthetic.make_scene(
        g, num_bg=NUM_BG, num_frames=NUM_FRAMES, num_cams=NUM_CAMS,
        width=WIDTH, height=HEIGHT, focal=FOCAL, num_rigid=RIGID,
        rigid_pts=PTS, num_deformable=DEFORM, deformable_pts=PTS, device=dev)
    data = synthetic.SyntheticData(scene)
    cfg = configs.flagship_config(data.num_images, NUM_FRAMES)
    state, statics = synthetic.random_state(
        scene, cfg, g, configs.FLAGSHIP_BG_CAPACITY,
        configs.FLAGSHIP_MAX_STEPS, device=dev)
    cfg = configs.flagship_config(data.num_images, NUM_FRAMES,
                                  isect_capacity=args.capacity)
    # the pipeline reaches the wrappers through its module references:
    # point those at copies whose wrapper records its first arguments
    captured = {}

    def stand_in(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            captured.setdefault(name, a)
            return fn(*a, **kw)
        return types.SimpleNamespace(**{**vars(mod), name: wrapped})

    pipeline.expand_cuda = stand_in(expand_cuda, "expand_gather")
    pipeline.rasterize_cuda = stand_in(rasterize_cuda, "rasterize_fwd")
    try:
        render_loop.render_images(cfg, state, statics, data, [0])
    finally:
        pipeline.expand_cuda, pipeline.rasterize_cuda = (expand_cuda,
                                                         rasterize_cuda)
    ea, ra = captured["expand_gather"], captured["rasterize_fwd"]
    img, n_live, ckpt_off, ckpt = rasterize_cuda.rasterize_fwd(
        *ra, residuals=True)
    live = torch.zeros(ckpt.shape[0], dtype=torch.bool, device=dev)
    for off, n in zip(ckpt_off.tolist(), n_live.tolist()):
        live[off:off + n] = True
    key, gid, feats = expand_cuda.expand_gather(*ea)
    print(json.dumps({
        "root": root,
        "expand_inputs": digest(ea[0], ea[1], ea[2]),
        "expand": digest(key, gid, feats),
        "rasterize_fwd_inputs": digest(*ra[:3]),
        "rasterize_fwd": digest(rasterize_cuda.rasterize_fwd(*ra)),
        "rasterize_fwd_residuals": digest(img, n_live, ckpt[live]),
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
