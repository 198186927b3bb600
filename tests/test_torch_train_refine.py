"""The port's refinement and loss pieces against the JAX package (helpers in
tests/test_torch_train.py). Split from that file: the port's test files hold
at most four tests each, bar one parametrized test or tests that share a
module fixture, so that pytest-xdist's count-ordered queue (--dist loadfile)
runs them after tests/test_parallel.py (README).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu.train import density as jdensity
from bilateral_driving_tpu.train import losses as jlosses
from bilateral_driving_tpu_torch.models import bilateral
from bilateral_driving_tpu_torch.train import density, losses

from test_torch_train import (
    _dup_parents, _refine_inputs, _rotmat, _split_parents)
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("step", [3400, 3100, 16100])
def test_refine_matches_jax(step):
    """Refinement on its own: 3400 densifies and culls (with screen-size
    terms), 3100 only resets opacities, 16100 only culls. Everything but
    the split offsets (drawn from jax.random there, from a
    torch.Generator here) must agree; the split children are held against
    their parents and the port's own draws."""
    cfg = jdensity.DensityConfig()
    params, aux, alive, stats, extra = _refine_inputs(step)
    jp, ja, jalive, jtouched, jinfo = jdensity.refine(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in aux.items()}, jnp.asarray(alive),
        jdensity.DensityStats(*map(jnp.asarray, stats)), step, 1.0, cfg,
        num_train_images=4, extra_cull=jnp.asarray(extra))
    gen = torch.Generator().manual_seed(5)
    replay = torch.Generator().manual_seed(5)
    t = lambda x: torch.from_numpy(np.array(x))
    tp, ta, talive, ttouched, tinfo = density.refine(
        gen, {k: t(v) for k, v in params.items()},
        {k: t(v) for k, v in aux.items()}, t(alive),
        density.DensityStats(*map(t, stats)), step, 1.0,
        density.DensityConfig(), num_train_images=4, extra_cull=t(extra))

    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    np.testing.assert_array_equal(ttouched.numpy(), np.asarray(jtouched))
    for k in ("splits", "dups", "culled", "dropped"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert tinfo["opacity_reset"] == bool(jinfo["opacity_reset"])
    if step == 3400:
        assert int(tinfo["splits"]) > 0 and int(tinfo["dups"]) > 0
        assert int(tinfo["dropped"]) > 0 and int(tinfo["culled"]) > 0

    # which parent each child came from: split pass s gives the k-th split
    # parent the k-th still-free slot, then duplicates do the same
    free = list(np.flatnonzero(~alive))
    parent = {}
    split_parents = _split_parents(params, stats, alive, step, cfg)
    assert len(split_parents) == int(tinfo["splits"])
    dup_parents = _dup_parents(params, stats, alive, step, cfg)
    for s in range(cfg.n_split_samples):
        for src in split_parents:
            if free:
                parent[free.pop(0)] = (src, s)
    for src in dup_parents:
        if free:
            parent[free.pop(0)] = (src, None)
    assert set(parent) == set(np.flatnonzero(ttouched.numpy()))

    child_of_split = {d for d, (_, s) in parent.items() if s is not None}
    keep = np.array([i not in child_of_split for i in range(alive.size)])
    np.testing.assert_array_equal(tp["instances_quats"].numpy(),
                                  params["instances_quats"])
    for k in density.PER_POINT_KEYS & set(params):
        np.testing.assert_allclose(tp[k].numpy()[keep],
                                   np.asarray(jp[k])[keep], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(ta["point_ids"].numpy(),
                                  np.asarray(ja["point_ids"]))
    if child_of_split:
        eps = [torch.randn((alive.size, 3), generator=replay)
               for _ in range(cfg.n_split_samples)]
        rot = jax.device_get(jax.vmap(_rotmat)(jnp.asarray(params["quats"])))
        scale = np.exp(params["log_scales"])
        for d, (src, s) in parent.items():
            if s is None:
                continue
            want = params["means"][src] + rot[src] @ (scale[src]
                                                      * eps[s][src].numpy())
            np.testing.assert_allclose(tp["means"][d].numpy(), want,
                                       rtol=1e-5, atol=1e-6)
            # log(exp(s) / 1.6) rounds through two library functions
            np.testing.assert_allclose(tp["log_scales"][d].numpy(),
                                       np.asarray(jp["log_scales"])[d],
                                       rtol=1e-6)
            for k in ("quats", "logit_opacities", "sh_dc", "sh_rest"):
                np.testing.assert_array_equal(tp[k][d].numpy(),
                                              np.asarray(jp[k])[d], k)


def test_loss_pieces_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for h, w in ((37, 53), (9, 7)):          # 9 x 7 shrinks the window
        np.testing.assert_allclose(
            float(losses.ssim(ta[:h, :w], tb[:h, :w])),
            float(jlosses.ssim(jnp.asarray(a[:h, :w]),
                               jnp.asarray(b[:h, :w]))), rtol=1e-5)
    occ = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    occ[::3] = 0.0
    occ[1::7] = 1.0
    gt = (rng.random((37, 53)) < 0.5).astype(np.float32)
    gt[::5] = occ[::5]                        # x == y: zero gradient
    for tf, jf in ((losses.bce, jlosses.bce),
                   (losses.safe_bce, jlosses.safe_bce)):
        to = torch.from_numpy(occ).requires_grad_(True)
        val = tf(to, torch.from_numpy(gt))
        (tg,) = torch.autograd.grad(val, to)
        jv, jg = jax.value_and_grad(lambda x: jf(x, jnp.asarray(gt)))(
            jnp.asarray(occ))
        np.testing.assert_allclose(float(val.detach()), float(jv), rtol=1e-5)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-9)
    pred = rng.uniform(0, 90, (37, 53)).astype(np.float32)
    lidar = np.where(rng.random((37, 53)) < 0.2,
                     rng.uniform(0, 100, (37, 53)), 0).astype(np.float32)
    hit = (lidar > 0).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.depth_loss(torch.from_numpy(pred),
                                torch.from_numpy(lidar),
                                torch.from_numpy(hit))),
        float(jlosses.depth_loss(jnp.asarray(pred), jnp.asarray(lidar),
                                 jnp.asarray(hit), loss_type="l1",
                                 normalize=False)), rtol=1e-5)
    np.testing.assert_allclose(float(losses.psnr(ta, tb)),
                               float(jlosses.psnr(jnp.asarray(a),
                                                  jnp.asarray(b))),
                               rtol=1e-5)

    levels = [{"grids": rng.normal(1, 0.3, (5, 12, gw, gy, gx)).astype(
        np.float32)} for gx, gy, gw in jbilateral.DEFAULT_MS_GRID]
    np.testing.assert_allclose(
        float(bilateral.multiscale_tv_loss(
            {"levels": [{"grids": torch.from_numpy(l["grids"])}
                        for l in levels]})),
        float(jbilateral.multiscale_tv_loss(
            {"levels": [{"grids": jnp.asarray(l["grids"])}
                        for l in levels]})), rtol=1e-5)
