#!/usr/bin/env python3
"""Card smoke run of the PyTorch/CUDA port (bilateral_driving_tpu_torch).

Renders the flagship omnire_ms_bilateral scene at full width on one NVIDIA
GPU through the port's entry points (eval.render_loop.render_images and
train.trainer.forward), and holds every hand-written kernel of that path
against its plain PyTorch version. Phases, each printed on its own line
with its result and elapsed seconds:

  env       PyTorch and CUDA versions, nvcc, ninja, PyYAML, the card
  build     nvcc builds of csrc/*.cu, cold and warm
  scene     the flagship scene from a seed: nuScenes at 1/3 (533 x 300),
            1,000,000 live background Gaussians in a 2,097,152 capacity,
            16 rigid x 4,096 and 8 deformable x 4,096 points, EnvLight
            R=1024, multi-scale bilateral grids over 240 images; the
            intersection capacity from probe_num_isects + autotune_capacity
  kernels   each kernel against its plain version at the main path's shapes
  render    6 frames (train views, test views with neighbour-averaged
            affines, one novel view) with the launch counters read per frame
  reference one frame again through the plain versions, compared
  times     CUDA-event times of each kernel, its plain version and its bound
  profile   one frame under torch.profiler: device busy time, idle share,
            the number of device operations and those that take the most
            device time

Then a `kernels` JSON line, the card's name and power limit as nvidia-smi
gives them, and, last, {"ok": true, "device": {...}}. Any failed check
raises, so the run exits non-zero and prints no result line; so does a run
without CUDA or outside a checkout of the repository.

Usage: python3 chip_smoke.py [--seed N]
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 533, 300          # nuScenes 1600 x 900 at 1/3
FOCAL = 1266.0 / 3.0              # nuScenes front camera fx at 1/3
NUM_FRAMES, NUM_CAMS = 40, 6      # 240 images
NUM_BG, RIGID, DEFORM, PTS = 1_000_000, 16, 8, 4096
TEST_STRIDE = 10
TRAIN_VIEWS = (0, 13, 62)         # image = frame * NUM_CAMS + camera
TEST_VIEWS = (60, 125)
RASTER_ATOL, RASTER_RTOL = 1e-4, 1e-5   # kernel vs plain, per element
FRAME_ATOL = 1e-4                       # rendered rgb, kernels vs plain
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
FP32_OPS_PER_S = 67e12            # H100 SXM, outside the tensor cores
# The least work each kernel must do on its inputs, for its bound.
# Expansion reads table rows 0-14 of each Gaussian that has entries (row 15
# is padding; row 3, the segment start, is what the search in offsets finds)
# and writes key, gid and 10 features per entry.
EXPAND_ROWS_READ = 15
# Compositing, in f32 operations: per live entry and tile, the mean relative
# to the tile origin and the halved a and c (4); per live (entry, pixel)
# pair, dx, dy and sigma = dx (a/2 dx + b dy) + dy (c/2 dy) - logop (10),
# then exp, clamp and the 1/255 gate (3); per pair past the gate, the
# weight, 4 channels x (multiply, add) and the transmittance update (10).
ENTRY_OPS, PAIR_OPS, BLEND_OPS = 4, 13, 10


class SmokeError(RuntimeError):
    pass


def check(cond, what: str):
    if not cond:
        raise SmokeError(what)


def phase(name: str, t0: float, **result):
    print(f"phase {name}: {json.dumps(result)} ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def kernels_replaced(pipeline, expand_gather, rasterize_fwd):
    """Point the pipeline's two kernel calls at stand-ins for a block. The
    pipeline reaches the kernels through its module references only."""
    real = (pipeline.expand_cuda, pipeline.rasterize_cuda)
    pipeline.expand_cuda = types.SimpleNamespace(expand_gather=expand_gather)
    pipeline.rasterize_cuda = types.SimpleNamespace(
        rasterize_fwd=rasterize_fwd)
    try:
        yield
    finally:
        pipeline.expand_cuda, pipeline.rasterize_cuda = real


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "bilateral_driving_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from bilateral_driving_tpu_torch import configs
    from bilateral_driving_tpu_torch.data import synthetic
    from bilateral_driving_tpu_torch.eval import render_loop
    from bilateral_driving_tpu_torch.ops import (cuda_build, expand_cuda,
                                                 pipeline, rasterize_cuda)
    from bilateral_driving_tpu_torch.ops.camera import viewmat_from_c2w
    from bilateral_driving_tpu_torch.train import trainer

    # ---- env
    t0 = time.perf_counter()
    nvcc = cuda_build.nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    smi = nvidia_smi()
    phase("env", t0, torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], nvcc=nvcc,
          nvcc_version=nvcc_ver.splitlines()[-1],
          ninja=shutil.which("ninja"),
          yaml=importlib.util.find_spec("yaml") is not None,
          device=torch.cuda.get_device_name(0),
          device_count=torch.cuda.device_count(), nvidia_smi=smi)

    # ---- build
    t0 = time.perf_counter()
    cold = cuda_build.build()
    cold_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    warm = cuda_build.build()
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
    phase("build", t0, cold_s=round(cold_s, 3), compiled=cold,
          warm_s=round(time.perf_counter() - t1, 4), warm_compiled=warm)

    # ---- scene
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(args.seed)
    scene = synthetic.make_scene(
        g, num_bg=NUM_BG, num_frames=NUM_FRAMES, num_cams=NUM_CAMS,
        width=WIDTH, height=HEIGHT, focal=FOCAL, num_rigid=RIGID,
        rigid_pts=PTS, num_deformable=DEFORM, deformable_pts=PTS, device=dev)
    data = synthetic.SyntheticData(scene)
    cfg = configs.flagship_config(data.num_images, NUM_FRAMES)
    state, statics = synthetic.random_state(
        scene, cfg, g, configs.FLAGSHIP_BG_CAPACITY,
        configs.FLAGSHIP_MAX_STEPS, device=dev)
    full_statics = trainer.merge_statics(statics, state.aux)
    neighbor_map = data.neighbor_train_indices(TEST_STRIDE)
    check(all(i in neighbor_map for i in TEST_VIEWS), "test views")

    novel = synthetic.make_batch(scene, 0)
    c2w = novel["camera_to_world"].clone()
    yaw = math.radians(5.0)
    rot = torch.tensor([[math.cos(yaw), 0.0, math.sin(yaw)], [0.0, 1.0, 0.0],
                        [-math.sin(yaw), 0.0, math.cos(yaw)]], device=dev)
    c2w[:3, :3] = rot @ c2w[:3, :3]
    c2w[:3, 3] += torch.tensor([-0.5, -0.2, 0.0], device=dev)
    novel["camera_to_world"] = c2w
    novel["viewdirs"] = synthetic.pixel_viewdirs(HEIGHT, WIDTH, scene.K, c2w)

    probes = []
    for batch, test in ([(data.get_batch(i), False) for i in TRAIN_VIEWS]
                        + [(data.get_batch(i), True) for i in TEST_VIEWS]
                        + [(novel, True)]):
        merged, _ = trainer.collect_gaussians(
            cfg, state.params, full_statics, state.masks,
            batch["camera_to_world"][:3, 3], state.step, batch["frame_idx"],
            batch["normed_time"], test)
        # dead slots (zero opacity) never get entries: probe the live ones
        live = merged.opacities > 0
        probes.append(pipeline.probe_num_isects(
            merged.means[live], merged.quats[live], merged.scales[live],
            viewmat_from_c2w(batch["camera_to_world"]), scene.K, WIDTH,
            HEIGHT, pipeline.RasterizeConfig(near_plane=cfg.near_plane,
                                             far_plane=cfg.far_plane)))
    cap = pipeline.autotune_capacity(max(probes), margin=1.1)
    cfg = configs.flagship_config(data.num_images, NUM_FRAMES,
                                  isect_capacity=cap)
    torch.cuda.synchronize()
    phase("scene", t0, width=WIDTH, height=HEIGHT,
          images=data.num_images, bg_capacity=configs.FLAGSHIP_BG_CAPACITY,
          bg_live=int(state.masks["Background"].sum()),
          rigid_points=int(state.masks["RigidNodes"].sum()),
          deformable_points=int(state.masks["DeformableNodes"].sum()),
          envlight_resolution=cfg.envlight_resolution,
          probe_num_isects=probes, isect_capacity=cap)

    # ---- kernels: capture the main path's kernel inputs on one frame; the
    # stand-ins record the arguments and call the real wrappers
    t0 = time.perf_counter()
    captured = {}

    def capturing(name, fn):
        def wrapped(*a):
            captured.setdefault(name, a)
            return fn(*a)
        return wrapped

    with kernels_replaced(
            pipeline, capturing("expand", expand_cuda.expand_gather),
            capturing("rasterize_fwd", rasterize_cuda.rasterize_fwd)):
        render_loop.render_images(cfg, state, statics, data, TRAIN_VIEWS[:1])
    check(set(captured) == {"expand", "rasterize_fwd"},
          f"captured {sorted(captured)}")

    ea = captured["expand"]
    k1, g1, f1 = expand_cuda.expand_gather(*ea)
    k2, g2, f2 = expand_cuda.expand_gather_plain(*ea)
    torch.cuda.synchronize()
    expand_equal = (torch.equal(k1, k2) and torch.equal(g1, g2)
                    and torch.equal(f1.view(torch.int32),
                                    f2.view(torch.int32)))
    feat_diff = torch.where(torch.isnan(f1) & torch.isnan(f2),
                            torch.zeros_like(f1), (f1 - f2).abs())
    expand_err = max(float((k1.long() - k2.long()).abs().max()),
                     float((g1.long() - g2.long()).abs().max()),
                     float(feat_diff.max()))
    check(expand_equal, "expand kernel differs from its plain version "
          f"(max abs err {expand_err})")

    ra = captured["rasterize_fwd"]
    img_k = rasterize_cuda.rasterize_fwd(*ra)
    img_p, n_live, n_blend = rasterize_cuda.rasterize_fwd_plain(*ra)
    torch.cuda.synchronize()
    raster_err = float((img_k - img_p).abs().max())
    raster_ok = bool(torch.all((img_k - img_p).abs()
                               <= RASTER_ATOL + RASTER_RTOL * img_p.abs()))
    check(torch.isfinite(img_k).all(), "compositing kernel output not finite")
    check(raster_ok, f"compositing kernel differs from its plain version "
          f"(max abs err {raster_err})")
    phase("kernels", t0, expand_bit_exact=expand_equal,
          expand_max_abs_err=expand_err,
          gaussians=int(ea[1].shape[0]) - 1, capacity=ea[3],
          rasterize_max_abs_err=raster_err,
          rasterize_tolerance=f"atol {RASTER_ATOL} + rtol {RASTER_RTOL}",
          tiles=int(ra[1].shape[0]), live_chunks=int(n_live.sum()))

    # ---- render: the main path, counters from 0
    t0 = time.perf_counter()
    launches = [0, 0]
    expand_cuda.expand_gather.launches = 0
    rasterize_cuda.rasterize_fwd.launches = 0
    frames, frame_s = [], []
    views = ([(i, None) for i in TRAIN_VIEWS] + [(i, None) for i in TEST_VIEWS]
             + [(None, novel)])
    for idx, batch in views:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if batch is None:
            res = render_loop.render_images(cfg, state, statics, data, [idx],
                                            neighbor_map)
            rgb, depth, opac = (res["rgbs"][0], res["depths"][0],
                                res["opacities"][0])
            num_isects, overflow = res["num_isects"][0], res["overflow"][0]
        else:
            o = trainer.forward(cfg, state.params, full_statics, state.masks,
                                batch, state.step, in_test_set=True,
                                novel_view=True)
            rgb, depth, opac = o["rgb"], o["depth"][..., 0], o["opacity"][..., 0]
            num_isects, overflow = o["info"]["num_isects"], o["info"]["overflow"]
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t1)
        now = [expand_cuda.expand_gather.launches,
               rasterize_cuda.rasterize_fwd.launches]
        check(now[0] > launches[0] and now[1] > launches[1],
              f"a kernel did not launch for view {idx}: {launches} -> {now}")
        launches = now
        check(rgb.shape == (HEIGHT, WIDTH, 3), f"rgb shape {rgb.shape}")
        check(all(bool(torch.isfinite(x).all()) for x in (rgb, depth, opac)),
              f"non-finite output for view {idx}")
        check(not bool(overflow), f"intersection overflow for view {idx}")
        check(int(num_isects) > 0, f"no intersections for view {idx}")
        frames.append({"image": idx, "num_isects": int(num_isects),
                       "opacity_mean": round(float(opac.mean()), 4),
                       "rgb_mean": round(float(rgb.mean()), 4)})
    n_frames = len(views)
    phase("render", t0, frames=frames,
          launches={"expand": launches[0], "rasterize_fwd": launches[1]},
          ms_per_frame=[round(1e3 * s, 2) for s in frame_s])

    # ---- reference: one frame through the plain versions
    t0 = time.perf_counter()
    batch = data.get_batch(TRAIN_VIEWS[0])
    o_k = trainer.forward(cfg, state.params, full_statics, state.masks,
                          batch, state.step)
    counts_before = [expand_cuda.expand_gather.launches,
                     rasterize_cuda.rasterize_fwd.launches]
    with kernels_replaced(
            pipeline, expand_cuda.expand_gather_plain,
            lambda *a: rasterize_cuda.rasterize_fwd_plain(*a)[0]):
        o_p = trainer.forward(cfg, state.params, full_statics, state.masks,
                              batch, state.step)
    check([expand_cuda.expand_gather.launches,
           rasterize_cuda.rasterize_fwd.launches] == counts_before,
          "a kernel launched in the plain reference frame")
    frame_err = float((o_k["rgb"] - o_p["rgb"]).abs().max())
    check(frame_err <= FRAME_ATOL,
          f"frame differs from its plain render by {frame_err}")
    phase("reference", t0, frame_max_abs_err=frame_err,
          tolerance=FRAME_ATOL)

    # ---- times, and each kernel's bound from this run's inputs
    t0 = time.perf_counter()
    offsets, e_cap = ea[1].long(), ea[3]
    used_gaussians = int((offsets[1:] > offsets[:-1]).sum())
    expand_bytes = (used_gaussians * EXPAND_ROWS_READ * 4 + 4
                    + e_cap * (4 + 4 + 4 * expand_cuda.NFEAT))
    feats_s, starts, counts = ra[0], ra[1], ra[2]
    start = starts.long()
    end = start + counts.long()
    live_end = torch.minimum(
        end, (torch.div(start, 128, rounding_mode="floor") + n_live) * 128)
    live_entries = int(torch.clamp(live_end - start, min=0).sum())
    blend_pairs = int(n_blend)
    raster_ops = (live_entries * (ENTRY_OPS + rasterize_cuda.PIX * PAIR_OPS)
                  + blend_pairs * BLEND_OPS)
    raster_bytes = (live_entries * 4 * rasterize_cuda.NFEAT
                    + starts.numel() * 8 + img_k.numel() * 4)
    kernels = []
    for name, source, replaces, fn, plain, nbytes, nops, err in [
            ("expand", "bilateral_driving_tpu_torch/csrc/expand.cu",
             "bilateral_driving_tpu/ops/expand_pallas.py:159",
             lambda: expand_cuda.expand_gather(*ea),
             lambda: expand_cuda.expand_gather_plain(*ea),
             expand_bytes, 0, expand_err),
            ("rasterize_fwd", "bilateral_driving_tpu_torch/csrc/rasterize_fwd.cu",
             "bilateral_driving_tpu/ops/rasterize_pallas.py:370",
             lambda: rasterize_cuda.rasterize_fwd(*ra),
             lambda: rasterize_cuda.rasterize_fwd_plain(*ra),
             raster_bytes, raster_ops, raster_err)]:
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * nops / FP32_OPS_PER_S
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[len(kernels)],
            "launches_per_frame": launches[len(kernels)] / n_frames,
            "max_abs_err": err,
            "ms": cuda_ms(fn, 20),
            "plain_ms": cuda_ms(plain, 3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        })
    phase("times", t0, ms_per_frame_median=round(
        1e3 * sorted(frame_s)[len(frame_s) // 2], 2),
          used_gaussians=used_gaussians, expand_bytes=expand_bytes,
          live_entries=live_entries, blend_pairs=blend_pairs,
          raster_ops=raster_ops,
          nvidia_smi=nvidia_smi())

    # ---- profile: where one frame's device time goes
    t0 = time.perf_counter()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    render_loop.render_images(cfg, state, statics, data, TRAIN_VIEWS[:1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        render_loop.render_images(cfg, state, statics, data, TRAIN_VIEWS[:1])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1)
    # device-side events only (kernels, copies): the operator events above
    # them carry the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    median_ms = 1e3 * sorted(frame_s)[len(frame_s) // 2]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    phase("profile", t0, profiled_frame_ms=round(wall_ms, 3),
          device_busy_ms=round(busy_ms, 3) if busy_ms else "not measured",
          device_ops=sum(e.count for e in events),
          device_idle_share_of_median_frame=(
              round(1.0 - busy_ms / median_ms, 4) if busy_ms
              else "not measured"),
          top_device_ms=[[e.key[:70], round(e.self_device_time_total / 1e3, 3),
                          e.count] for e in top])

    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
