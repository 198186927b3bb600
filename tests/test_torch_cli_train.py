"""The port's metrics and colour correction against the JAX package, and the
training CLI's resume (helpers in tests/test_torch_cli.py). Split from that
file: the port's test files hold at most four tests each, bar one
parametrized test or tests that share a module fixture, so that pytest-
xdist's count-ordered queue (--dist loadfile) runs them after
tests/test_parallel.py (README).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from bilateral_driving_tpu.eval import metrics as jmetrics
from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu_torch.eval import metrics
from bilateral_driving_tpu_torch.models import bilateral
from bilateral_driving_tpu_torch.tools import eval as eval_cli
from bilateral_driving_tpu_torch.tools import train as train_cli

from test_torch_cli import TINY, _assert_same, _final
from test_torch_threads import one_torch_thread  # noqa: F401


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    h, w = 40, 56
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(
        np.float32)
    masks = [(rng.uniform(size=(h, w)) < p).astype(np.float32)
             for p in (0.3, 0.2, 0.1, 0.0)]
    got = metrics.image_metrics(pred, gt, *masks)
    want = jmetrics.image_metrics(pred, gt, *masks)
    assert set(got) == set(want) and "vehicle_psnr" not in got
    for k in want:
        # SSIM: the same 11 x 11 Gaussian filter, summed in other orders
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    depth = rng.uniform(1, 60, (h, w)).astype(np.float32)
    lidar = np.where(rng.uniform(size=(h, w)) < 0.1,
                     depth + rng.normal(0, 1, (h, w)), 0).astype(np.float32)
    K = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [1.0, -2.0, 3.0]
    assert metrics.depth_metrics(depth, lidar) == \
        jmetrics.depth_metrics(depth, lidar)
    pd = metrics.depth_to_points(depth * (lidar > 0), K, c2w)
    pg = metrics.depth_to_points(lidar, K, c2w)
    np.testing.assert_array_equal(
        pd, jmetrics.depth_to_points(depth * (lidar > 0), K, c2w))
    for pct in (None, 97):
        assert metrics.chamfer_distance(pd, pg, pct) == \
            jmetrics.chamfer_distance(pd, pg, pct)
    classes = {"dynamic": masks[0], "human": masks[3]}
    assert metrics.per_class_chamfer(depth, lidar, K, c2w, classes) == \
        jmetrics.per_class_chamfer(depth, lidar, K, c2w, classes)
    assert metrics.lpips(pred, gt) is None


def test_color_correct_matches_jax():
    rng = np.random.default_rng(5)
    ref = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    img = np.clip(0.8 * ref ** 1.2 + 0.05 + rng.normal(0, 0.02, ref.shape),
                  0, 1).astype(np.float32)
    want = np.asarray(jbilateral.color_correct(jnp.asarray(img),
                                               jnp.asarray(ref)))
    got = bilateral.color_correct(torch.from_numpy(img),
                                  torch.from_numpy(ref)).numpy()
    # both solve the same 10-column least squares in float32 through
    # different factorisations (JAX's SVD solver, torch's pseudo-inverse):
    # a few float32 ulps of the unit-range colours
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cli_resume_equals_uninterrupted_run(tmp_path):
    """Six steps, two per window, across a resolution-schedule change
    (steps 0-2 at half size), a refine at step 4 and a checkpoint after
    step 3; resuming from that checkpoint ends in the same state. Then
    tools.eval writes finite metrics."""
    run = TINY + ["trainer.max_steps=6", "trainer.steps_per_dispatch=2",
                  "density.warmup_steps=2", "density.refine_interval=4",
                  "res_schedule.double_steps=3",
                  "res_schedule.downscale_times=1", "logging.ckpt_every=3",
                  "logging.log_every=2", "logging.metrics_flush_every=2"]
    out = str(tmp_path)
    full = train_cli.main(["--device", "cpu", "--output_root", out,
                           "--run_name", "full", *run])
    assert full["downscales"] == {"2": 3, "1": 3}
    assert [r["step"] for r in full["refines"]] == [4]
    assert full["nonfinite_params_max"] == 0 and full["overflow_steps"] == 0
    assert all(v == 0 for v in full["launches"].values())
    ckpt = os.path.join(out, "full", "checkpoints", "checkpoint_4.pt")
    resumed = train_cli.main(["--device", "cpu", "--output_root", out,
                              "--run_name", "resumed", "--resume_from", ckpt,
                              *run])
    assert (resumed["start_step"], resumed["end_step"]) == (4, 6)
    assert [{k: r[k] for k in ("step", "after", "dropped")}
            for r in resumed["refines"]] == \
        [{k: r[k] for k in ("step", "after", "dropped")}
         for r in full["refines"]]
    a, b = _final(os.path.join(out, "full")), _final(
        os.path.join(out, "resumed"))
    for k in ("params", "aux", "masks", "stats", "opt", "step", "updates",
              "generator", "extra"):
        _assert_same(a[k], b[k], k)
    with open(os.path.join(out, "full", "config.json")) as f:
        assert json.load(f)["trainer"]["max_steps"] == 6

    got = eval_cli.main(["--log_dir", os.path.join(out, "full"),
                         "--device", "cpu", "--max_images", "1",
                         "--compute_geo"])
    for split in ("test", "full"):
        with open(os.path.join(out, "full", f"metrics_{split}.json")) as f:
            m = json.load(f)
        assert m == got[split]
        assert all(np.isfinite(v) for v in m.values()
                   if isinstance(v, float))
        assert {"psnr", "ssim", "depth_rmse", "chamfer"} <= set(m)
