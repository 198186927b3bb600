"""The training CLI's parallel plans on every card of one machine.

Trains tests/fixtures/proto_scene through tools.train (PIL blocked, as
chip_smoke.py runs it) once on one device and then with each parallel
plan over `--ranks` devices (data-parallel, tile-parallel and, for an
even count above 2, a 2 x (ranks / 2) hybrid), one after the other; for
each run: its steps/s after the first flushed window, its peak
device memory on every rank, whether every rank's final checkpoint
(parameters, Adam moments, statistics, masks, generator, sampler) has
the same bits as rank 0's, and the final loss and PSNR beside the
single-device run's.

    python -m bilateral_driving_tpu_torch.tools.parallel_smoke \\
        [--ranks N] [--steps 60] [--device cuda] [--out FILE] [key=value ...]

Overrides after the flags go to every run (tiny capacities for a CPU
rehearsal: `--device cpu --ranks 4 background_init.capacity=1024 ...`).
Prints one JSON line with the card's nvidia-smi name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

FIXTURE = ["data.scene_dir=tests/fixtures/proto_scene",
           "data.pixel_pack=tests/fixtures/proto_scene_pixels.npz",
           "data.cameras=[0,1]", "data.num_cams=2", "data.downscale=1",
           "smpl.model_path=synthetic", "background_init.capacity=262144",
           "logging.vis_freq=0", "logging.ckpt_every=1000000",
           "density.warmup_steps=20", "density.refine_interval=20",
           "res_schedule.double_steps=0"]
NO_PIL = ("import runpy, sys; sys.modules['PIL'] = None; "
          "sys.argv = sys.argv[1:]; runpy.run_module(sys.argv[0], "
          "run_name='__main__', alter_sys=True)")
STATE_KEYS = ("params", "aux", "masks", "stats", "opt", "step", "updates",
              "generator", "extra")


def same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_bits, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout
    except FileNotFoundError:
        return "no nvidia-smi"
    return out.strip().splitlines()[0]


def run(root: str, name: str, flags, overrides, device: str) -> dict:
    """One tools.train run in a subprocess; its summary, with every rank's
    checkpoint compared to rank 0's."""
    cmd = [sys.executable, "-c", NO_PIL, "bilateral_driving_tpu_torch.tools."
           "train", "--output_root", root, "--run_name", name, "--device",
           device, *flags, *overrides]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{name} exited {r.returncode}:\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    run_dir = os.path.join(root, name)
    with open(os.path.join(run_dir, "train_summary.json")) as f:
        summ = json.load(f)
    ranks = (summ["parallel"] or {}).get("ranks", 1)
    dirs = [run_dir] + [os.path.join(run_dir, f"proc{r}")
                        for r in range(1, ranks)]
    ckpts, peaks = [], []
    for d in dirs:
        last = sorted(os.listdir(os.path.join(d, "checkpoints")),
                      key=lambda x: int(x.split("_")[1].split(".")[0]))[-1]
        ckpts.append(torch.load(os.path.join(d, "checkpoints", last),
                                map_location="cpu", weights_only=False))
        with open(os.path.join(d, "train_summary.json")) as f:
            peaks.append(json.load(f)["peak_mem_bytes"])
    return {"flags": list(flags), "parallel": summ["parallel"],
            "steps": summ["steps"],
            "steps_per_s_after_warmup": summ["steps_per_s_after_warmup"],
            "peak_mem_bytes": peaks, "last_metrics": summ["last_metrics"],
            "ranks_bit_equal": all(same_bits(c[k], ckpts[0][k])
                                   for c in ckpts[1:] for k in STATE_KEYS),
            "launches": summ["launches"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of each plan (default: every CUDA device)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)
    n = args.ranks or torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"parallel_smoke: {n} device(s); a plan needs 2")
    plans = [["--data_parallel", str(n)], ["--tile_parallel", str(n)]]
    if n % 2 == 0 and n > 2:
        plans.append(["--data_parallel", "2", "--tile_parallel",
                      str(n // 2)])
    overrides = FIXTURE + [f"trainer.max_steps={args.steps}",
                           "logging.log_every=10",
                           "logging.metrics_flush_every=10"] + args.opts
    root = tempfile.mkdtemp(prefix="parallel_smoke_", dir=os.getcwd())
    try:
        runs = {"single": run(root, "single", [], overrides, args.device)}
        for flags in plans:
            name = "_".join(f.strip("-") for f in flags)
            runs[name] = run(root, name, flags, overrides, args.device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result = {"ranks": n, "device": args.device,
              "device_count": torch.cuda.device_count(),
              "nvidia_smi": nvidia_smi(), "runs": runs}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    bad = [k for k, v in runs.items() if not v["ranks_bit_equal"]]
    if bad:
        raise SystemExit(f"ranks differ in {bad}")
    return result


if __name__ == "__main__":
    main()
