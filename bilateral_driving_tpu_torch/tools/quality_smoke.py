"""Long training run of the port with asserted interpolation-quality floors.

The port's counterpart of tools/quality_smoke.py, with its protocol:
trains a preset (`--config`, omnire_ms_bilateral by default) with
`trainer.use_smpl=true` and `smpl.model_path=synthetic` (the pedestrian in
SMPLNodes, its body the port's own random draw: the licensed SMPL asset is
not used) on tests/fixtures/proto_scene (30 frames x 2 cameras at 96 x 64,
read from its pixel pack) through tools.train, holds out every 10th frame,
evaluates with tools.eval --compute_geo, and asserts the same floors set
in advance: test PSNR >= 20 and SSIM >= 0.55, full-split PSNR >= 22 and
SSIM >= 0.60. Every preset gets the same overrides, as the JAX package's
tools/quality_variants.py runs other configs on the same fixture.
(QUALITY_torch.json is the record of this tool's run before SMPL was
ported, without the SMPL switch: the pedestrian in DeformableNodes.)

    python -m bilateral_driving_tpu_torch.tools.quality_smoke \
        [--config omnire] [--steps 5000] [--runs 1] [--out PATH] \
        [--workdir DIR] [--device cuda]

Writes the record (the keys of QUALITY_r05.json plus peak device memory,
the device and its nvidia-smi name and power limit) at the repo root:
QUALITY_torch_smpl.json for omnire_ms_bilateral, QUALITY_torch_<config>.json
(without its "omnire_" prefix) for another preset. `--runs N` (N > 1)
trains N runs of the same command side by side and writes
QUALITY_torch_spread.json instead (or --out): each run's metrics, their
spread (max - min) and mean, whether every metric of every run is
identical, and no steps/s (the runs share the card and the host).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

from ..configs import PRESETS

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCENE = os.path.join(REPO, "tests", "fixtures", "proto_scene")
PACK = os.path.join(REPO, "tests", "fixtures", "proto_scene_pixels.npz")

PSNR_FLOOR = 20.0
SSIM_FLOOR = 0.55
FULL_PSNR_FLOOR = 22.0
FULL_SSIM_FLOOR = 0.60


def overrides(steps: int) -> list:
    return [
        f"data.scene_dir={SCENE}", f"data.pixel_pack={PACK}",
        "data.num_cams=2", "data.cameras=[0,1]", "data.test_image_stride=10",
        "data.downscale=1",
        f"trainer.max_steps={steps}",
        "trainer.steps_per_dispatch=8",
        "trainer.use_smpl=true",
        "smpl.model_path=synthetic",
        "trainer.sh_degree=2",
        "trainer.sh_degree_interval=500",
        "trainer.envlight_resolution=64",
        "render.isect_capacity=262144",
        "render.capacity_policy=rebucket",
        "background_init.capacity=32768",
        "background_init.num_lidar_samples=12000",
        "background_init.num_near_pts=4000",
        "background_init.num_far_pts=4000",
        "rigid_capacity=4096",
        "density.warmup_steps=300", "density.refine_interval=200",
        "density.stop_split_at=4000",
        "res_schedule.double_steps=800", "res_schedule.downscale_times=1",
        "logging.ckpt_every=1000000", "logging.vis_freq=0",
        "logging.log_every=240", "logging.metrics_flush_every=240",
    ]


def _f(v):
    return float(v) if v is not None else float("nan")


def nvidia_smi() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    return r.stdout.strip().splitlines()[0]


def record_name(config: str) -> str:
    """The record's file name for a preset."""
    if config == "omnire_ms_bilateral":
        return "QUALITY_torch_smpl.json"
    return f"QUALITY_torch_{config.removeprefix('omnire_')}.json"


def _cli(module: str, device: str, log: str, *argv) -> subprocess.Popen:
    """A CLI of the port in a subprocess, its output into the file `log`
    (side-by-side runs would fill and block one another's pipes)."""
    os.makedirs(os.path.dirname(log), exist_ok=True)
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m",
             f"bilateral_driving_tpu_torch.tools.{module}", "--device",
             device, *argv], cwd=REPO, stdout=f, stderr=subprocess.STDOUT)


def _finish(proc: subprocess.Popen, log: str, what: str, tail: int = 3000):
    proc.wait()
    with open(log) as f:
        sys.stdout.write(f.read()[-tail:])
    if proc.returncode != 0:
        raise SystemExit(f"{what} failed")


def run_metrics(run_dir: str) -> dict:
    """The record's quality keys of one evaluated run, and its checks
    against the floors (a list of what failed)."""
    def load(name):
        with open(os.path.join(run_dir, name)) as f:
            return json.load(f)

    metrics, full = load("metrics_test.json"), load("metrics_full.json")
    summary = load("train_summary.json")
    psnr, ssim = metrics["psnr"], metrics["ssim"]
    out = {
        "test_psnr": round(float(psnr), 3),
        "test_ssim": round(float(ssim), 4),
        "full_psnr": round(float(full["psnr"]), 3),
        "full_ssim": round(float(full["ssim"]), 4),
        "test_human_psnr": round(_f(metrics.get("human_psnr")), 3),
        "test_vehicle_psnr": round(_f(metrics.get("vehicle_psnr")), 3),
        "test_dynamic_psnr": round(_f(metrics.get("dynamic_psnr")), 3),
        "lpips": metrics.get("lpips"),
        "test_depth_rmse": _f(metrics.get("depth_rmse")),
        "test_depth_med_se": _f(metrics.get("depth_med_se")),
        "test_chamfer": _f(metrics.get("chamfer")),
        "test_chamfer_p97": _f(metrics.get("chamfer_p97")),
        "test_chamfer_dynamic": _f(metrics.get("chamfer_dynamic")),
        "test_chamfer_human": _f(metrics.get("chamfer_human")),
        "test_chamfer_vehicle": _f(metrics.get("chamfer_vehicle")),
        "full_depth_rmse": _f(full.get("depth_rmse")),
        "full_chamfer": _f(full.get("chamfer")),
    }
    checks = [
        (psnr >= PSNR_FLOOR, f"test PSNR {psnr} < floor {PSNR_FLOOR}"),
        (ssim >= SSIM_FLOOR, f"test SSIM {ssim} < floor {SSIM_FLOOR}"),
        (full["psnr"] >= FULL_PSNR_FLOOR, f"full PSNR {full['psnr']}"),
        (full["ssim"] >= FULL_SSIM_FLOOR, f"full SSIM {full['ssim']}"),
        (math.isfinite(out["test_depth_rmse"]), "no depth RMSE"),
        (math.isfinite(out["test_chamfer"]), "no chamfer"),
        (math.isfinite(out["test_human_psnr"]), "no human PSNR"),
        (math.isfinite(out["test_vehicle_psnr"]), "no vehicle PSNR"),
        ("SMPLNodes" in summary["final_points"],
         "the pedestrian is not in SMPLNodes"),
        (bool(summary["refines"]), "no refinement ran"),
    ]
    return out, summary, [what for ok, what in checks if not ok]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="omnire_ms_bilateral",
                   choices=sorted(PRESETS))
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--runs", type=int, default=1,
                   help="runs of the same command side by side on one "
                        "card; more than one writes the spread record")
    p.add_argument("--out", default=None)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    out = args.out or os.path.join(
        REPO, "QUALITY_torch_spread.json" if args.runs > 1
        else record_name(args.config))
    workdir = args.workdir or os.path.join(REPO, "work_dirs",
                                           "quality_smoke_torch")
    names = [f"q{args.steps}_{args.config}" + (f"_{i}" if args.runs > 1
                                                 else "")
             for i in range(args.runs)]
    logs = {name: os.path.join(workdir, f"{name}.log") for name in names}
    t0 = time.time()
    trains = [_cli("train", args.device, logs[name], "--config",
                   args.config, "--output_root", workdir, "--run_name", name,
                   *overrides(args.steps)) for name in names]
    for proc, name in zip(trains, names):
        _finish(proc, logs[name], "train CLI")
    wall = time.time() - t0
    evals = [_cli("eval", args.device, logs[name] + ".eval", "--log_dir",
                  os.path.join(workdir, name), "--compute_geo")
             for name in names]
    for proc, name in zip(evals, names):
        _finish(proc, logs[name] + ".eval", "eval CLI", 2000)
    runs = [run_metrics(os.path.join(workdir, name)) for name in names]
    summary = runs[0][1]
    smi = nvidia_smi()
    common = {
        "scene": "proto_scene (raycast fixture, 96x64, 2 cams x 30 frames, "
                 "interior frames 10 & 20 held out via stride 10)",
        "config": f"{args.config} + use_smpl (smpl.model_path="
                  "synthetic: the port's own random body of 256 vertices, "
                  "not the JAX package's draw); tools/quality_smoke.py's "
                  "overrides",
        "steps": args.steps,
        "floors": {"psnr": PSNR_FLOOR, "ssim": SSIM_FLOOR,
                   "full_psnr": FULL_PSNR_FLOOR,
                   "full_ssim": FULL_SSIM_FLOOR},
        "backend": f"torch {summary['device']}",
        "device": summary["device"],
        "power_limit": smi,
    }
    if args.runs == 1:
        artifact = {
            **common,
            "wallclock_s": round(wall, 1),
            "steps_per_s": round(args.steps / wall, 2),
            "train_steps_per_s_after_warmup":
                summary["steps_per_s_after_warmup"],
            **runs[0][0],
            "peak_mem_bytes": summary["peak_mem_bytes"],
            "refines": len(summary["refines"]),
            "final_points": summary["final_points"],
            "isect_capacity": summary["isect_capacity"],
            "rebuckets": summary["rebuckets"],
        }
    else:
        keys = [k for k, v in runs[0][0].items() if isinstance(v, float)]
        artifact = {
            **common,
            "runs": args.runs,
            "side_by_side": "the runs shared one card and its host, so "
                            "no steps/s is recorded from them",
            "per_run": [r[0] for r in runs],
            "spread": {k: max(r[0][k] for r in runs)
                       - min(r[0][k] for r in runs) for k in keys},
            "mean": {k: sum(r[0][k] for r in runs) / len(runs)
                     for k in keys},
            "peak_mem_bytes": [r[1]["peak_mem_bytes"] for r in runs],
            # every metric of every run equal to the last digit
            "identical": all(r[0][k] == runs[0][0][k] for r in runs
                             for k in keys),
        }
    with open(out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact))
    failed = [f"run {i}: {what}" for i, r in enumerate(runs)
              for what in r[2]]
    if failed:
        raise SystemExit("; ".join(failed))
    print("QUALITY SMOKE OK")


if __name__ == "__main__":
    main()
