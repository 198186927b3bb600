"""The port's LPIPS against the JAX package's eval/lpips_jax.py: weights
in its init_random's shapes and distributions, written to an npz in
tools/export_lpips_weights.py's layout (conv OIHW, bias, lin (1, C, 1,
1)) and read back by both packages' load_weights_npz; two image pairs of
48 x 32 within 1e-5 relative. Then eval/metrics.lpips with
BILATERAL_LPIPS_WEIGHTS naming that file, and None without one."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.eval import lpips_jax
from bilateral_driving_tpu_torch.eval import lpips, metrics, render_loop
from test_torch_threads import one_torch_thread  # noqa: F401

H, W = 32, 48
RTOL = 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    # init_random's shapes and distributions, drawn by numpy (its own
    # threefry draws of 14.7 M weights take 7-14 s on the CPU)
    shapes = jax.eval_shape(lpips_jax.init_random, jax.random.key(3))
    rng = np.random.default_rng(3)
    out = {}
    for i, (w, b) in enumerate(shapes.convs):
        out[f"conv{i}_w"] = (0.05 * rng.normal(size=w.shape)).astype(
            np.float32).transpose(3, 2, 0, 1)                 # HWIO -> OIHW
        out[f"conv{i}_b"] = (0.05 * rng.normal(size=b.shape)).astype(
            np.float32)
    for j, lin in enumerate(shapes.lins):
        out[f"lin{j}_w"] = rng.uniform(size=lin.shape).astype(
            np.float32).reshape(1, -1, 1, 1)
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz")
    np.savez(path, **out)
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(
        np.float32)
    want = np.asarray(lpips_jax.lpips(lpips_jax.load_weights_npz(path),
                                      jnp.asarray(pred), jnp.asarray(gt)))
    return dict(path=path, pred=pred, gt=gt, want=want)


def test_lpips_matches_jax(weights):
    params = lpips.load_weights_npz(weights["path"])
    assert len(params.convs) == len(lpips.VGG16_PLAN) == 13
    assert [p.shape[0] for p in params.lins] == [
        lpips.VGG16_PLAN[t][0] for t in lpips.TAP_AFTER]
    got = lpips.lpips(params, torch.from_numpy(weights["pred"]),
                      torch.from_numpy(weights["gt"]))
    assert got.shape == (2,) and bool((got > 0).all())
    np.testing.assert_allclose(got.numpy(), weights["want"], rtol=RTOL)
    # one image pair gives a scalar; an image against itself 0
    one = lpips.lpips(params, torch.from_numpy(weights["pred"][1]),
                      torch.from_numpy(weights["gt"][1]))
    np.testing.assert_allclose(float(one), weights["want"][1], rtol=RTOL)
    same = torch.from_numpy(weights["gt"][0])
    assert float(lpips.lpips(params, same, same)) == 0.0
    # the port writes the layout it reads
    again = os.path.join(os.path.dirname(weights["path"]), "again.npz")
    lpips.save_weights_npz(params, again)
    back = lpips.load_weights_npz(again)
    assert all(torch.equal(a, b) for (a, _), (b, _) in
               zip(params.convs, back.convs))
    assert all(torch.equal(a, b) for a, b in zip(params.lins, back.lins))


def test_metrics_lpips_with_and_without_weights(weights, monkeypatch):
    """metrics.lpips and image_metrics read the npz that
    BILATERAL_LPIPS_WEIGHTS names; without one, None and aggregate_metrics'
    null."""
    pred, gt = weights["pred"][0], weights["gt"][0]
    monkeypatch.setenv("BILATERAL_LPIPS_WEIGHTS", weights["path"])
    got = metrics.lpips(pred, gt)
    np.testing.assert_allclose(got, weights["want"][0], rtol=RTOL)
    per = metrics.image_metrics(pred, gt)
    assert per["lpips"] == got
    assert render_loop.aggregate_metrics([per])["lpips"] == got
    monkeypatch.setenv("BILATERAL_LPIPS_WEIGHTS", "")
    monkeypatch.chdir(os.path.dirname(weights["path"]))   # no data/ here
    assert metrics.lpips(pred, gt) is None
    agg = render_loop.aggregate_metrics([metrics.image_metrics(pred, gt)])
    assert agg["lpips"] is None and "lpips_note" in agg
