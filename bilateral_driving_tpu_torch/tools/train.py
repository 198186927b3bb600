"""Training CLI: port of bilateral_driving_tpu/tools/train.py.

    python -m bilateral_driving_tpu_torch.tools.train \
        --config omnire_ms_bilateral --output_root ./work_dirs \
        --run_name myrun data.scene_dir=/path/to/processed/scene \
        [data.pixel_pack=scene_pixels.npz] [--device cpu] [key=value ...]
    python -m bilateral_driving_tpu_torch.tools.train \
        --config_file my_method.yaml [--dataset_file my_rig.yaml] ...

Starts from a preset of configs.PRESETS (`--config`) or a method YAML
(`--config_file`, read by utils/config.load_yaml without PyYAML), merges
a dataset rig (`--dataset_file`, or the tree's `dataset` key, e.g.
dataset=waymo/3cams, resolved against configs.DATASET_PRESETS, the port's
copy of the JAX package's configs/datasets), then applies dotted
`key=value` overrides (YAML scalars and flow lists), builds the scene
from its directory (tools/common.build_real_scene) or, with
`data.synthetic` (the `synthetic` preset), the generated scene
(build_synthetic_scene of tools/common: its ground truth rendered once
by the forward, then every parameter moved by 0.05 N(0, 1) so training
starts away from it), and trains it on `--device` (default cuda; no CPU
fallback):
error-buffer importance sampling with its periodic refresh, the
coarse-to-fine resolution schedule, `trainer.steps_per_dispatch`
steps per window (a plain loop; host events land on window starts), a
pending-metrics window flushed every `logging.metrics_flush_every` steps
with the non-finite loss and non-finite parameter guards and the
`render.capacity_policy` (rebucket | error | ignore), JSONL metrics and
full-state checkpoints every `logging.ckpt_every` steps. `--resume_from`
continues from a checkpoint exactly as the uninterrupted run would.

The run directory `<output_root>/<project>/<run_name>` (as the JAX CLI's;
without `--project`, `<output_root>/<run_name>`, the layout the port's
eval, render and viewer commands, README and chip_smoke.py use: the JAX
CLI's default project names the JAX package) receives config.json,
metrics.json, log.txt, checkpoints/, test_metrics.json (the first 20 test
images) and train_summary.json (steps, steps/s, peak device memory,
kernel launch counts, refinements, guards, the first and last flushed
loss and PSNR); every `logging.vis_freq` steps (from step 0) an
images/step_<step>.png snapshot of one frame's cameras, ground truth over
render over depth over error (utils/visualization); TensorBoard events in
tb/ (utils/tb, written by the port itself) and a copy of the port's
sources in backup/ (utils/backup). In synthetic mode the metrics come
from every frame, as every frame trains. `--viewer_port PORT` serves the
live viewer (tools/viewer) while training; `--enable_wandb` logs to wandb
(the project named by `--project`) where it is installed.

Parallel training (parallel/), the JAX CLI's plan: `--data_parallel N`
trains a batch of N images a step, one per device (-1: every device);
`--tile_parallel T` splits each image's rasterization into T bands over T
devices, with --data_parallel a (data x tile) grid (render.isect_capacity
is per band); both start their ranks from this one command
(torch.multiprocessing, a file:// rendezvous in the run directory), each
rank on `cuda:<rank>` or, with --device cpu, on the CPU. `--coordinator
HOST:PORT --num_processes P --process_id I` makes this process rank I of a
data-parallel run of P processes started apart (one device each; not with
--tile_parallel). NCCL joins CUDA ranks, gloo CPU ranks. Rank 0 writes the
run directory, rank r > 0 `proc<r>` under it; every rank keeps the same
replicated state. `trainer.steps_per_dispatch` is ignored on the parallel
path. A rank that fails ends the run with a non-zero exit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import configs
from ..data import importance, synthetic
from ..eval import render_loop
from ..ops import pipeline
from ..parallel import data_parallel, distributed, tile_parallel
from ..train import checkpoint, trainer
from ..utils import backup as backup_lib
from ..utils import config as config_lib
from ..utils import tb as tb_lib
from ..utils import visualization
from ..utils.logging import MetricLogger, logger, setup_logging
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group()
    src.add_argument("--config", default=None,
                     choices=sorted(configs.PRESETS),
                     help="a preset (default omnire_ms_bilateral)")
    src.add_argument("--config_file", default=None,
                     help="a method YAML in the JAX package's schema")
    p.add_argument("--dataset_file", default=None,
                   help="a dataset rig YAML merged over the method's tree")
    p.add_argument("--output_root", default="./work_dirs")
    p.add_argument("--project", default=None,
                   help="write to <output_root>/<project>/<run_name> "
                        "(default: <output_root>/<run_name>); the wandb "
                        "project")
    p.add_argument("--run_name", default="run")
    p.add_argument("--resume_from", default=None,
                   help="checkpoint file to continue from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--viewer_port", type=int, default=0,
                   help="serve the live viewer on this port while training "
                        "(0: off)")
    p.add_argument("--enable_wandb", action="store_true",
                   help="log to wandb where the package is installed "
                        "(offline without an API key)")
    # multi-device / multi-process (parallel/)
    p.add_argument("--tile_parallel", type=int, default=0,
                   help="shard each image's rasterization into N horizontal"
                        " bands over a `tile` mesh axis (hybrid with"
                        " --data_parallel; parallel/tile_parallel.py)."
                        " render.isect_capacity is PER BAND")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="shard each step's image batch over this many "
                        "devices (0 = single device, -1 = all devices)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for multi-host runs (or "
                        "an init method URL, e.g. file:///shared/path)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("opts", nargs="*", help="dotlist overrides key=value")
    return p.parse_args(argv)


def config_tree(args) -> config_lib.ConfigDict:
    """The run's tree: the preset or method YAML, merged with the dataset
    rig of --dataset_file or of the tree's (or an override's) `dataset`
    key, then the overrides (the JAX CLI's tools/train.py:68-92)."""
    if args.config_file:
        base = config_lib.load_yaml(args.config_file)
    else:
        base = config_lib.wrap(
            configs.PRESETS[args.config or "omnire_ms_bilateral"])
    if args.dataset_file:
        rig = config_lib.load_yaml(args.dataset_file)
    else:
        name = config_lib.apply_dotlist(base, args.opts).get("dataset")
        rig = configs.DATASET_PRESETS.get(name) if name else None
        if name and rig is None:
            logger.warning(f"dataset={name!r} names no rig of "
                           f"{sorted(configs.DATASET_PRESETS)}: none merged")
    if rig is not None:
        base = config_lib.merge(base, rig)
    return config_lib.apply_dotlist(base, args.opts)


def device_of(name: str) -> torch.device:
    """The requested device; a CUDA device must exist (no fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return dev


def launch_counts() -> dict:
    """Launch counters of the port's CUDA kernel wrappers."""
    from ..ops import (cubemap_cuda, expand_cuda, rasterize_cuda, scan_cuda,
                       segsum_cuda)

    return {"expand": expand_cuda.expand_gather.launches,
            "rasterize_fwd": rasterize_cuda.rasterize_fwd.launches,
            "rasterize_bwd": rasterize_cuda.rasterize_bwd.launches,
            "segment_sum": segsum_cuda.segment_sum.launches,
            "segment_sum_rows": segsum_cuda.segment_sum_rows.launches,
            "splat_grad": cubemap_cuda.splat_grad.launches,
            "scan": scan_cuda.scan_rows.launches}


def build(cfg, seed: int, dev):
    """Scene, trainer config and fresh training state of a config tree:
    the scene directory of cfg.data, or with data.synthetic the generated
    scene as synthetic.RenderedFrames of its perturbed start."""
    if cfg.get_path("data.synthetic", False):
        return build_synthetic(cfg, seed, dev)
    tcfg, data, params, statics, aux, masks = common.build_real_scene(
        cfg, seed, dev)
    state = trainer.init_state(
        tcfg, params, masks, aux,
        generator=torch.Generator(device=dev).manual_seed(seed))
    return tcfg, data, statics, state


def build_synthetic(cfg, seed: int, dev):
    """Synthetic mode (the JAX CLI's tools/train.py:106-134): the
    generated scene's frames rendered once by the forward and clipped to
    [0, 1] are the targets; then every floating parameter moves by 0.05
    N(0, 1), drawn from a CPU generator seeded seed + 4, so the run starts
    away from them."""
    tcfg, scene, params, statics, aux, masks = \
        common.build_synthetic_scene(cfg, seed, dev)
    full = trainer.merge_statics(statics, aux)
    with torch.no_grad():
        pixels = [torch.clamp(trainer.forward(
            tcfg, params, full, masks, synthetic.make_batch(scene, f),
            0)["rgb"], 0.0, 1.0) for f in range(scene.num_frames)]
        g = torch.Generator().manual_seed(seed + 4)
        for _, p in trainer.named_leaves(params):
            p += 0.05 * torch.randn(p.shape, generator=g,
                                    dtype=p.dtype).to(p.device)
    state = trainer.init_state(
        tcfg, params, masks, aux,
        generator=torch.Generator(device=dev).manual_seed(seed))
    return tcfg, synthetic.RenderedFrames(scene, pixels), statics, state


def run_dir(args) -> str:
    """<output_root>/<project>/<run_name>, or <output_root>/<run_name>."""
    return os.path.join(args.output_root, *(
        [args.project] if args.project else []), args.run_name)


def parallel_plan(args, dev):
    """(n_data, n_tile) of a run started by this one command, the JAX
    CLI's plan (tools/train.py:152-207): n_data 0 trains on one device
    without a process group, n_tile > 1 is a (data x tile) grid. None for
    a rank of a multi-process run (--num_processes)."""
    tile_n = max(args.tile_parallel, 0)
    if args.num_processes is not None:
        if tile_n > 1:
            raise ValueError("--tile_parallel with --num_processes is not "
                             "supported yet (tile bands are intra-host)")
        return None
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    if tile_n > 1:
        plan = (max(count // tile_n, 1) if args.data_parallel < 0
                else max(args.data_parallel, 1)), tile_n
    elif args.data_parallel < 0 or args.data_parallel > 1:
        plan = (count if args.data_parallel < 0 else args.data_parallel), 1
    else:
        return 0, 1
    if dev.type == "cuda" and plan[0] * plan[1] > count:
        raise ValueError(f"{plan[0]} x {plan[1]} ranks need as many CUDA "
                         f"devices, have {count}")
    return plan


def rank_device(dev: torch.device, rank: int) -> torch.device:
    """A rank's device: CUDA device rank % count, or the CPU."""
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, argv, n_data: int, n_tile: int, store: str,
               threads: int):
    """One local rank of a parallel run (torch.multiprocessing's target)."""
    torch.set_num_threads(threads)
    args = parse_args(argv)
    dev = rank_device(device_of(args.device), rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(distributed.backend_for(dev), init_method=store,
                            world_size=n_data * n_tile, rank=rank)
    try:
        return train(args, dev, n_data, n_tile)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    dev = device_of(args.device)
    plan = parallel_plan(args, dev)
    if plan is None:
        # a rank of a multi-process run started apart
        dev = rank_device(dev, args.process_id or 0)
        multiprocess = distributed.maybe_initialize(distributed.DistConfig(
            args.coordinator, args.num_processes, args.process_id), dev)
        try:
            return train(args, dev, dist.get_world_size() if multiprocess
                         else 0, 1)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    n_data, n_tile = plan
    if n_data == 0:
        return train(args, dev, 0, 1)
    # local ranks: a file store in the run directory, fresh for this run
    base = run_dir(args)
    os.makedirs(base, exist_ok=True)
    store_file = os.path.abspath(os.path.join(base, "rendezvous"))
    if os.path.exists(store_file):
        os.remove(store_file)
    store = f"file://{store_file}"
    ranks = n_data * n_tile
    try:
        if ranks == 1:
            return _rank_main(0, argv, n_data, n_tile, store,
                              torch.get_num_threads())
        mp.spawn(_rank_main, nprocs=ranks, join=True, args=(
            argv, n_data, n_tile, store,
            max(torch.get_num_threads() // ranks, 1)))
    finally:
        if os.path.exists(store_file):
            os.remove(store_file)
    with open(os.path.join(base, "train_summary.json")) as f:
        return json.load(f)


def train(args, dev, n_data: int, n_tile: int):
    """Train on `dev`: alone (n_data 0), or as this process's rank of an
    initialised process group, data parallel over n_data ranks (n_tile
    1) or over a (n_data x n_tile) grid. Returns the train summary."""
    if n_data == 0:
        mesh = None
    elif n_tile > 1:
        mesh = tile_parallel.make_hybrid_mesh(n_data, n_tile, dev)
    else:
        mesh = data_parallel.make_mesh(n_data, device=dev)
    rank = dist.get_rank() if mesh is not None else 0
    cfg = config_tree(args)
    synthetic_mode = bool(cfg.get_path("data.synthetic", False))
    log_dir = run_dir(args)
    if rank > 0:
        log_dir = os.path.join(log_dir, f"proc{rank}")
    os.makedirs(log_dir, exist_ok=True)
    setup_logging(log_dir)
    config_lib.save_config(cfg, os.path.join(log_dir, "config.json"))
    # per-run source snapshot (utils/backup.py:39-56 of the reference)
    backup_lib.backup_project(log_dir)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t_build = time.perf_counter()
    tcfg, data, statics, state = build(cfg, args.seed, dev)
    test_stride = cfg.get_path("data.test_image_stride", 10)
    train_indices, test_indices = data.split_train_test(test_stride)
    neighbor_map = data.neighbor_train_indices(test_stride)
    logger.info(f"classes: {trainer.gaussian_classes(tcfg)}  images: "
                f"{data.num_images}  device: {dev}  built in "
                f"{time.perf_counter() - t_build:.1f}s")

    sampler = importance.ImageSampler(
        data.num_images, cfg.get_path("data.num_cams", 1),
        buffer_ratio=cfg.get_path("sampler.buffer_ratio", 0.5),
        start_enhance_weight=cfg.get_path("sampler.start_enhance_weight", 1.0),
        seed=args.seed)

    cap_policy = cfg.get_path("render.capacity_policy", "rebucket")
    if cap_policy not in ("rebucket", "error", "ignore"):
        raise ValueError(f"render.capacity_policy={cap_policy!r}")
    cap_margin = float(cfg.get_path("render.capacity_margin", 1.35))
    cap_floor = int(cfg.get_path("render.capacity_floor",
                                 pipeline.CAP_BUCKET))
    rebucket_after = int(cfg.get_path("render.rebucket_after", 2))
    cap_state = {"bad_windows": 0, "max_isects": 0}

    if args.resume_from:
        state, extra = checkpoint.restore_checkpoint(args.resume_from, state)
        sampler.load_state_dict(extra["sampler"])
        cap_state.update(extra["cap_state"])
        tcfg = dataclasses.replace(tcfg,
                                   isect_capacity=extra["isect_capacity"])
        logger.info(f"resumed from {args.resume_from} @ step {state.step}")

    spd = max(int(cfg.get_path("trainer.steps_per_dispatch", 1) or 1), 1)
    hybrid = isinstance(mesh, tile_parallel.HybridMesh)
    if mesh is not None:
        logger.info((f"hybrid data x tile over {mesh.data.size} x "
                     f"{mesh.tile.size} ranks" if hybrid else
                     f"data-parallel over {mesh.size} ranks")
                    + f", this rank {rank} on {dev}")
        if spd > 1:
            logger.info("steps_per_dispatch ignored on the parallel path")
            spd = 1
    max_steps = tcfg.max_steps
    ckpt_every = cfg.get_path("logging.ckpt_every", 10000)
    log_every = cfg.get_path("logging.log_every", 100)
    vis_freq = int(cfg.get_path("logging.vis_freq", 0) or 0)
    refresh_every = int(cfg.get_path("sampler.refresh_every", 0) or 0)
    refresh_downscale = int(cfg.get_path("sampler.refresh_downscale", 4))
    flush_every = max(int(cfg.get_path("logging.metrics_flush_every",
                                       min(log_every, 50)) or 1), 1)
    rs_double = int(cfg.get_path("res_schedule.double_steps", 0) or 0)
    rs_times = int(cfg.get_path("res_schedule.downscale_times", 0) or 0)
    mlogger = MetricLogger(output_file=os.path.join(log_dir, "metrics.json"))
    tbw = tb_lib.TBWriter(os.path.join(log_dir, "tb"))
    wb = tb_lib.WandbWriter(args.enable_wandb,
                            args.project or "bilateral_driving_tpu_torch",
                            args.run_name, config=dict(cfg), log_dir=log_dir)
    ckpt_dir = os.path.join(log_dir, "checkpoints")

    def sched_downscale(step: int) -> int:
        """Coarse to fine (base.py:142-146): 1/2^downscale_times of the
        resolution at first, doubling every double_steps."""
        if rs_double <= 0:
            return 1
        return 2 ** max(rs_times - step // rs_double, 0)

    def visualize(step: int) -> None:
        """Every camera of a frame that sweeps the sequence over the run,
        tiled as ground truth, render, depth and error rows
        (tools/train.py:196-246 of the reference), and the sampler's
        error buffer as a (cameras, frames) heat map; TensorBoard and wandb
        get both images and the frame's metrics. Not in synthetic mode,
        as in the JAX package."""
        if synthetic_mode:
            return
        n_vis = max(max_steps // vis_freq, 1)
        frame = int(np.linspace(0, data.num_frames, n_vis + 1,
                                endpoint=False, dtype=int)[step // vis_freq])
        idxs = np.flatnonzero(data.frame_of_image == frame)
        res = render_loop.render_images(tcfg, state, statics, data, idxs,
                                        neighbor_map=neighbor_map,
                                        compute_metrics=True)
        agg = render_loop.aggregate_metrics(res["metrics"])
        res = {k: [x.cpu().numpy() for x in res[k]]
               for k in ("rgbs", "gt_rgbs", "depths")}
        names = [data.camera_names()[int(data.cam_of_image[i])]
                 for i in idxs]
        grid = visualization.snapshot_grid(res, names, data.dataset,
                                           max_depth=tcfg.max_depth)
        os.makedirs(os.path.join(log_dir, "images"), exist_ok=True)
        visualization.save_png(grid, os.path.join(log_dir, "images",
                                                  f"step_{step}.png"))
        # the reference's buffer-map videos (tools/train.py:320-350)
        wts = sampler._weights(train_indices)
        hm = np.zeros(data.num_images, np.float32)
        hm[np.asarray(train_indices)] = wts / max(wts.max(), 1e-12)
        ncam = max(int(cfg.get_path("data.num_cams", 1)), 1)
        rows = -(-data.num_images // ncam)
        hm = np.pad(hm, (0, rows * ncam - data.num_images)).reshape(
            rows, ncam).T
        hm_img = np.repeat(np.repeat(hm, 8, 0), 8, 1)[..., None].repeat(3, -1)
        image_metrics = {f"image_metrics/{k}": v for k, v in agg.items()}
        for w in (tbw, wb):
            w.image("sampler/error_buffer", hm_img, step)
            w.scalars(image_metrics, step)
            w.image("image_rendering/gt_rgbs_render_rgbs_depths_error",
                    grid, step)

    def refresh_error_buffer() -> None:
        """Every train image's error at low resolution, so rarely drawn
        images do not keep stale priorities (pixel_source.py:948-983)."""
        res = render_loop.render_images(
            tcfg, state, statics, data, train_indices,
            neighbor_map=neighbor_map, downscale=refresh_downscale)
        for idx, pred, gt in zip(train_indices, res["rgbs"], res["gt_rgbs"]):
            sampler.update_error(int(idx), max(
                float(torch.mean(torch.abs(pred - gt))), 1e-6))
        logger.info(f"error buffer refreshed over {len(train_indices)} "
                    f"train images at 1/{refresh_downscale} res")

    # what train_summary.json reports besides the counts and times
    summary = {"refines": [], "rebuckets": [], "overflow_steps": 0,
               "nonfinite_params_max": 0.0, "downscales": {},
               "first_metrics": None, "last_metrics": None}
    last_points = {}
    pending: list = []   # (step, image indices, metrics of device scalars)

    def flush_pending() -> None:
        """One device-to-host copy of the window's metrics, then the
        guards, the sampler's error updates and the capacity policy."""
        nonlocal tcfg
        if not pending:
            return
        keys = sorted(pending[0][2])
        vals = torch.stack([torch.stack([m[k].float() for k in keys])
                            for _, _, m in pending]).cpu().numpy()
        window_overflow = 0.0
        for (s, idxs_s, _), row in zip(pending, vals):
            m = dict(zip(keys, row.tolist()))
            if not np.isfinite(m["loss"]):
                raise RuntimeError(f"non-finite loss at step {s} (detected "
                                   f"<= {flush_every} steps later): {m}")
            summary["nonfinite_params_max"] = max(
                summary["nonfinite_params_max"], m["nonfinite_params"])
            if m["nonfinite_params"] > 0:
                raise RuntimeError(
                    f"{int(m['nonfinite_params'])} non-finite parameter "
                    f"entries at step {s} (loss {m['loss']:.4f})")
            for i in idxs_s:
                sampler.update_error(int(i), max(m["loss"], 1e-6))
            window_overflow = max(window_overflow, m["isect_overflow"])
            summary["overflow_steps"] += int(m["isect_overflow"] > 0)
            cap_state["max_isects"] = max(cap_state["max_isects"],
                                          int(m["num_isects"]))
            points = {k[len("num_points/"):]: int(v) for k, v in m.items()
                      if k.startswith("num_points/")}
            if s > 0 and s % tcfg.density.refine_interval == 0:
                summary["refines"].append({
                    "step": s, "before": last_points.get(s - 1),
                    "after": points, "dropped": int(m["refine_dropped"])})
            last_points.clear()
            last_points[s] = points
            summary["last_metrics"] = {"step": s, "loss": m["loss"],
                                       "psnr": m["psnr"]}
            if summary["first_metrics"] is None:
                summary["first_metrics"] = summary["last_metrics"]
        last_step = pending[-1][0]
        pending.clear()
        if cap_policy == "ignore" or window_overflow <= 0:
            cap_state["bad_windows"] = 0
            cap_state["max_isects"] = 0
            return
        if cap_policy == "error":
            raise RuntimeError(
                f"intersection capacity {tcfg.isect_capacity} overflowed "
                f"(num_isects={cap_state['max_isects']}) at step <= "
                f"{last_step}; render.capacity_policy=error")
        cap_state["bad_windows"] += 1
        if cap_state["bad_windows"] < rebucket_after:
            return
        new_cap = max(
            pipeline.autotune_capacity(cap_state["max_isects"],
                                       margin=cap_margin, floor=cap_floor),
            tcfg.isect_capacity + pipeline.CAP_BUCKET
            if cap_floor >= pipeline.CAP_BUCKET
            else 2 * tcfg.isect_capacity)
        logger.warning(
            f"isect overflow persisted {cap_state['bad_windows']} flush "
            f"windows (num_isects={cap_state['max_isects']}): capacity "
            f"{tcfg.isect_capacity} -> {new_cap}")
        summary["rebuckets"].append({"step": last_step,
                                     "from": tcfg.isect_capacity,
                                     "to": new_cap})
        tcfg = dataclasses.replace(tcfg, isect_capacity=new_cap)
        cap_state["bad_windows"] = 0
        cap_state["max_isects"] = 0

    def save(step=None) -> str:
        return checkpoint.save_checkpoint(
            ckpt_dir, state, step=step,
            extra={"sampler": sampler.state_dict(),
                   "cap_state": dict(cap_state),
                   "isect_capacity": tcfg.isect_capacity})

    def window_len(s: int) -> int:
        """Steps from s in one window: at most steps_per_dispatch, ending
        before the next pre-step event (snapshot, error-buffer refresh,
        resolution change) and right after the next post-step event (log,
        flush, checkpoint)."""
        k = min(spd, max_steps - s)
        for prd in (refresh_every, rs_double, vis_freq):
            if prd > 0:
                k = min(k, prd - s % prd)
        for prd in (log_every, flush_every, ckpt_every):
            if prd and prd > 0:
                r = s % prd
                k = min(k, (prd - r if r else 0) + 1)
        return max(k, 1)

    # the live viewer (reference init_viewer, base.py:755-762): frames of
    # the current state, the training stats, a pause button
    live_viewer = None
    step_lock = contextlib.nullcontext()
    if args.viewer_port and rank == 0:
        from . import viewer as viewer_mod

        live_viewer = viewer_mod.Viewer(
            viewer_mod.novel_view_renderer(
                lambda: (tcfg, state), statics,
                data.get_batch(int(train_indices[0]))),
            port=args.viewer_port).start()
        step_lock = live_viewer.lock
        logger.info(f"live viewer at http://127.0.0.1:{live_viewer.port}/")

    def parallel_step(step: int, ds: int):
        """One step of this rank: the images the step trains (every rank's
        sampler, seeded alike, proposes the same batch and the rank takes
        its row; ranks of a multi-process run draw process_train_indices)
        and (state, metrics)."""
        if args.num_processes is not None:
            idxs = [int(i) for i in distributed.process_train_indices(
                train_indices, args.seed, step, mesh)]
            batch = distributed.host_local_batch_to_global(
                data.get_batch(idxs[0], ds), mesh)
        else:
            rows = mesh.data if hybrid else mesh
            idxs = [int(sampler.propose(train_indices))
                    for _ in range(rows.size)]
            batch = data.get_batch(idxs[rows.rank], ds)
        step_fn = (tile_parallel.tile_train_step if hybrid
                   else data_parallel.parallel_train_step)
        return idxs, step_fn(tcfg, statics, mesh)(state, batch)

    start_step = step = int(state.step)
    t0 = time.perf_counter()
    t_win, win_start = t0, start_step
    t_warm, warm_step, ckpt_s = None, None, 0.0
    while step < max_steps:
        if live_viewer is not None:
            live_viewer.wait_if_paused()
        ds = sched_downscale(step)
        k = window_len(step)
        with step_lock:
            if vis_freq > 0 and step % vis_freq == 0:
                visualize(step)
            if (refresh_every > 0 and step > 0 and step % refresh_every == 0
                    and not synthetic_mode):
                refresh_error_buffer()
            if mesh is not None:
                idxs, (state, metrics) = parallel_step(step, ds)
                pending.append((step, idxs, metrics))
            else:
                idxs = [int(sampler.propose(train_indices))
                        for _ in range(k)]
                for j, idx in enumerate(idxs):
                    state, metrics = trainer.train_step(
                        tcfg, statics, state, data.get_batch(idx, ds))
                    pending.append((step + j, [idx], metrics))
        summary["downscales"][str(ds)] = summary["downscales"].get(
            str(ds), 0) + k
        last = step + k - 1       # post-step events key off the window end
        if last % flush_every == 0 or last == max_steps - 1:
            flush_pending()
            if t_warm is None:
                # the first flushed window is the warm-up
                t_warm, warm_step = time.perf_counter(), last + 1
        if last % log_every == 0:
            flush_pending()
            fetched = {kk: float(v) for kk, v in metrics.items()}
            m = {kk: v for kk, v in fetched.items()
                 if not kk.startswith("loss/")}
            mlogger.update(**m)
            mlogger.dump(last)
            tbw.scalars(fetched, last)
            wb.scalars(fetched, last)
            now = time.perf_counter()
            win_ms = (now - t_win) / max(last - win_start, 1) * 1e3
            t_win, win_start = now, last
            if live_viewer is not None:
                live_viewer.update_stats(
                    step=last, steps_per_s=1e3 / max(win_ms, 1e-9),
                    num_points=sum(int(v) for kk, v in fetched.items()
                                   if kk.startswith("num_points/")),
                    loss=m["loss"])
            logger.info(
                f"step {last}/{max_steps} "
                + " ".join(f"{kk}={v:.4f}" for kk, v in m.items())
                + f" ({(time.perf_counter() - t0) / max(last + 1 - start_step, 1):.3f}s/it)")
        if last > 0 and last % ckpt_every == 0:
            flush_pending()
            t1 = time.perf_counter()
            logger.info(f"checkpoint: {save()}")
            ckpt_s += time.perf_counter() - t1
        step += k
    flush_pending()
    t_end = time.perf_counter()
    if live_viewer is not None:
        summary["viewer_frames"] = live_viewer.frames_served
        live_viewer.stop()
    counts = launch_counts()
    path = save(step=max_steps)
    logger.info(f"final checkpoint: {path}")

    steps_run = max_steps - start_step
    timed = (max_steps - warm_step) if warm_step is not None else 0
    summary.update({
        "start_step": start_step, "end_step": max_steps,
        "steps": steps_run,
        "wall_s": t_end - t0,
        "checkpoint_s": ckpt_s,
        "steps_per_s_after_warmup": (
            timed / (t_end - t_warm - ckpt_s) if timed > 0 else None),
        "warmup_steps": (warm_step - start_step) if warm_step else None,
        "isect_capacity": tcfg.isect_capacity,
        "launches": counts,
        "device": str(dev),
        "parallel": (None if mesh is None else {
            "ranks": mesh.size, "rank": rank,
            "data": mesh.data.size if hybrid else mesh.size,
            "tile": mesh.tile.size if hybrid else 1,
            "backend": dist.get_backend()}),
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        "final_points": last_points.get(max_steps - 1),
        "image_hw": list(data.get_batch(int(train_indices[0]))[
            "pixels"].shape[:2]),
    })

    # quick eval on the test split (in synthetic mode on every frame)
    eval_indices = train_indices if synthetic_mode else test_indices[:20]
    if len(eval_indices):
        results = render_loop.render_images(
            tcfg, state, statics, data, eval_indices,
            neighbor_map=neighbor_map, compute_metrics=True)
        agg = render_loop.aggregate_metrics(results["metrics"])
        logger.info(f"test metrics: {agg}")
        with open(os.path.join(log_dir, "test_metrics.json"), "w") as f:
            json.dump(agg, f, indent=2)
    tbw.close()
    wb.close()
    with open(os.path.join(log_dir, "train_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
