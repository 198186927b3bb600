"""PVG's temporal densification against the JAX package (helpers in
tests/test_torch_backgrounds.py). Split from that file: the port's test
files hold at most four tests each, bar one parametrized test or tests that
share a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.train import density as jdensity
from bilateral_driving_tpu_torch import configs
from bilateral_driving_tpu_torch.train import density

from test_torch_backgrounds import _refine_inputs, _rotmat, _t
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("no_time_split", [True, False])
def test_pvg_refine_matches_jax(no_time_split):
    """One PVG refinement (step 3400, pvg.yaml's density block around a
    scene origin): the same alive slots and children; every child's fields
    but its drawn position and time equal the JAX package's, a split
    child's position and time equal its parent's plus the port's own
    draws; a duplicate equals its parent."""
    rng = np.random.default_rng(4)
    params, alive, stats = _refine_inputs(rng)
    dens = dict(configs.PVG_TREE["density"], no_time_split=no_time_split)
    jcfg = jdensity.DensityConfig(**{k: v for k, v in dens.items()
                                     if k in jdensity.DensityConfig._fields})
    tcfg = density.DensityConfig(**jcfg._asdict())
    origin, scale, cycle = (1.0, 0.0, -2.0), 0.5, 0.2
    jp, _, jalive, jtouched, jinfo = jax.jit(
        lambda p, a, st: jdensity.refine(
            jax.random.key(0), p, {}, a, st, 3400, scale, jcfg,
            num_train_images=4, pvg_cycle=cycle, scene_origin=origin))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive),
        jdensity.DensityStats(*map(jnp.asarray, stats)))
    gen = torch.Generator().manual_seed(7)
    tp, _, talive, ttouched, tinfo = density.refine(
        gen, {k: _t(v) for k, v in params.items()}, {}, _t(alive),
        density.DensityStats(*map(_t, stats)), 3400, scale, tcfg,
        num_train_images=4, pvg_cycle=cycle, scene_origin=origin)
    np.testing.assert_array_equal(ttouched.numpy(), np.asarray(jtouched))
    for k in ("splits", "dups", "dropped"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert int(tinfo["splits"]) > 0 and int(tinfo["dups"]) > 0
    assert int(tinfo["culled"]) > 0 and int(tinfo["dropped"]) == 0
    touched = ttouched.numpy()
    jp = {k: np.asarray(v) for k, v in jp.items()}
    for k in density.PER_POINT_KEYS:
        got = tp[k].numpy()
        rows = ~touched if k in ("means", "taus") else slice(None)
        np.testing.assert_allclose(got[rows], jp[k][rows], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # children by parent (sh_dc rows are distinct draws): split children
    # first (pass 0, pass 1), a duplicate last
    replay = torch.Generator().manual_seed(7)
    draws = []
    for _ in range(tcfg.n_split_samples):
        eps = torch.randn((alive.size, 3), generator=replay).numpy()
        t_eps = torch.randn((alive.size,), generator=replay).numpy()
        draws.append((eps, t_eps))
    rot = jax.device_get(jax.vmap(_rotmat)(jnp.asarray(params["quats"])))
    scale_xyz, beta = np.exp(params["log_scales"]), np.exp(params["log_betas"])
    key_of = {params["sh_dc"][i].tobytes(): i for i in range(alive.size)}
    children = {}
    for d in np.flatnonzero(touched):
        children.setdefault(key_of[tp["sh_dc"][d].numpy().tobytes()],
                            []).append(d)
    n_split, split_child = 0, np.zeros(alive.size, bool)
    for src, ds in children.items():
        kinds = (["split", "split", "dup"] if len(ds) == 3 else
                 ["split", "split"] if len(ds) == 2 else ["dup"])
        for s, (d, kind) in enumerate(zip(sorted(ds), kinds)):
            if kind == "dup":
                for k in ("means", "taus"):
                    np.testing.assert_array_equal(tp[k][d].numpy(),
                                                  tp[k][src].numpy())
                continue
            n_split += 1
            split_child[d] = True
            eps, t_eps = draws[s]
            te = t_eps[src] * beta[src]
            v_eff = params["velocity"][src] * np.exp(-0.5 * beta[src] / cycle)
            want = (params["means"][src] + rot[src] @ (scale_xyz[src]
                                                       * eps[src])
                    + v_eff * te)
            np.testing.assert_allclose(tp["means"][d].numpy(), want,
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(float(tp["taus"][d]),
                                       params["taus"][src] + te, rtol=1e-5,
                                       atol=1e-7)
    assert n_split == 2 * int(tinfo["splits"])
    # a split child's cull depends on its drawn position (the size factor
    # around the origin): the same slots live elsewhere, and a split child
    # lives by the cull rule at its own position
    talive = talive.numpy()
    np.testing.assert_array_equal(talive[~split_child],
                                  np.asarray(jalive)[~split_child])
    m = tp["means"].numpy()[split_child]
    g = np.linalg.norm(m - np.asarray(origin, np.float32), axis=-1) \
        * scale - 1.0
    gamma = np.where(g <= 1.0, 1.0, g) / scale
    culls = ((1 / (1 + np.exp(-tp["logit_opacities"].numpy()[split_child,
                                                               0]))
              < jcfg.cull_alpha_thresh)
             | (np.exp(tp["log_scales"].numpy()[split_child]).max(-1)
                > jcfg.cull_scale_thresh * scale * gamma)
             | (stats.max_radii[split_child] > jcfg.cull_screen_size))
    np.testing.assert_array_equal(talive[split_child], ~culls)
