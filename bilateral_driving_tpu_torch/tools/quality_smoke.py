"""Long training run of the port with asserted interpolation-quality floors.

The port's counterpart of tools/quality_smoke.py, with its protocol:
trains omnire_ms_bilateral with `trainer.use_smpl=true` and
`smpl.model_path=synthetic` (the pedestrian in SMPLNodes, its body the
port's own random draw: the licensed SMPL asset is not used) on
tests/fixtures/proto_scene (30 frames x 2 cameras at 96 x 64, read from its
pixel pack) through tools.train, holds out every 10th frame, evaluates
with tools.eval --compute_geo, and asserts the same floors set in advance:
test PSNR >= 20 and SSIM >= 0.55, full-split PSNR >= 22 and SSIM >= 0.60.
(QUALITY_torch.json is the record of this tool's run before SMPL was
ported, without the SMPL switch: the pedestrian in DeformableNodes.)

    python -m bilateral_driving_tpu_torch.tools.quality_smoke \
        [--steps 5000] [--out QUALITY_torch_smpl.json] [--device cuda]

Writes the record (the keys of QUALITY_r05.json plus peak device memory,
the device and its nvidia-smi name and power limit) at the repo root.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--out",
                   default=os.path.join(REPO, "QUALITY_torch_smpl.json"))
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    workdir = args.workdir or os.path.join(REPO, "work_dirs",
                                           "quality_smoke_torch")
    run_name = f"q{args.steps}"
    run_dir = os.path.join(workdir, run_name)
    t0 = time.time()
    train = subprocess.run(
        [sys.executable, "-m", "bilateral_driving_tpu_torch.tools.train",
         "--device", args.device, "--output_root", workdir,
         "--run_name", run_name] + overrides(args.steps),
        cwd=REPO, capture_output=True, text=True)
    wall = time.time() - t0
    sys.stdout.write(train.stdout[-3000:])
    sys.stderr.write(train.stderr[-3000:])
    if train.returncode != 0:
        raise SystemExit("train CLI failed")
    ev = subprocess.run(
        [sys.executable, "-m", "bilateral_driving_tpu_torch.tools.eval",
         "--device", args.device, "--log_dir", run_dir, "--compute_geo"],
        cwd=REPO, capture_output=True, text=True)
    sys.stdout.write(ev.stdout[-2000:])
    sys.stderr.write(ev.stderr[-2000:])
    if ev.returncode != 0:
        raise SystemExit("eval CLI failed")

    def load(name):
        with open(os.path.join(run_dir, name)) as f:
            return json.load(f)

    metrics, full = load("metrics_test.json"), load("metrics_full.json")
    summary = load("train_summary.json")
    if not summary["refines"]:
        raise SystemExit("no refinement ran")
    psnr, ssim = metrics["psnr"], metrics["ssim"]
    smi = nvidia_smi()
    artifact = {
        "scene": "proto_scene (raycast fixture, 96x64, 2 cams x 30 frames, "
                 "interior frames 10 & 20 held out via stride 10)",
        "config": "omnire_ms_bilateral + use_smpl (smpl.model_path="
                  "synthetic: the port's own random body of 256 vertices, "
                  "not the JAX package's draw); tools/quality_smoke.py's "
                  "overrides",
        "steps": args.steps,
        "wallclock_s": round(wall, 1),
        "steps_per_s": round(args.steps / wall, 2),
        "train_steps_per_s_after_warmup": summary["steps_per_s_after_warmup"],
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
        "floors": {"psnr": PSNR_FLOOR, "ssim": SSIM_FLOOR,
                   "full_psnr": FULL_PSNR_FLOOR,
                   "full_ssim": FULL_SSIM_FLOOR},
        "backend": f"torch {summary['device']}",
        "peak_mem_bytes": summary["peak_mem_bytes"],
        "device": summary["device"],
        "power_limit": smi,
        "refines": len(summary["refines"]),
        "final_points": summary["final_points"],
        "isect_capacity": summary["isect_capacity"],
        "rebuckets": summary["rebuckets"],
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact))
    checks = [
        (psnr >= PSNR_FLOOR, f"test PSNR {psnr} < floor {PSNR_FLOOR}"),
        (ssim >= SSIM_FLOOR, f"test SSIM {ssim} < floor {SSIM_FLOOR}"),
        (full["psnr"] >= FULL_PSNR_FLOOR, f"full PSNR {full['psnr']}"),
        (full["ssim"] >= FULL_SSIM_FLOOR, f"full SSIM {full['ssim']}"),
        (math.isfinite(artifact["test_depth_rmse"]), "no depth RMSE"),
        (math.isfinite(artifact["test_chamfer"]), "no chamfer"),
        (math.isfinite(artifact["test_human_psnr"]), "no human PSNR"),
        (math.isfinite(artifact["test_vehicle_psnr"]), "no vehicle PSNR"),
        ("SMPLNodes" in summary["final_points"],
         "the pedestrian is not in SMPLNodes"),
    ]
    failed = [what for ok, what in checks if not ok]
    if failed:
        raise SystemExit("; ".join(failed))
    print("QUALITY SMOKE OK")


if __name__ == "__main__":
    main()
