"""The port's render and overflow, dense oracle and capacity probe against the
JAX package (helpers in tests/test_torch_pipeline.py). Split from that file:
the port's test files hold at most four tests each, bar one parametrized
test or tests that share a module fixture, so that pytest-xdist's count-
ordered queue (--dist loadfile) runs them after tests/test_parallel.py
(README).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import pipeline as jpipeline
from bilateral_driving_tpu.ops import projection as jprojection
from bilateral_driving_tpu.ops import rasterize_ref as jref
from bilateral_driving_tpu_torch.ops import pipeline, rasterize_ref

from test_torch_pipeline import (HEIGHT, KEYS, WIDTH, _jax_args, _scene,
                                 _torch_args, g)
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("cap", [256, 2 ** 14])
def test_render_and_overflow_match_jax(cap):
    """Same image, intersection count, gauss ids and overflow flag as the
    JAX pipeline, also when the capacity truncates the entries."""
    s = _scene(5)
    cfg = jpipeline.RasterizeConfig(near_plane=0.3, isect_capacity=cap,
                                    interpret=True, pallas_expand=False)
    jo = jpipeline.rasterize(*[jnp.asarray(s[k]) for k in KEYS], WIDTH,
                             HEIGHT, cfg)
    to = pipeline.rasterize(*[torch.from_numpy(s[k]) for k in KEYS], WIDTH,
                            HEIGHT, pipeline.RasterizeConfig(
                                near_plane=0.3, isect_capacity=cap))
    assert int(to["info"]["num_isects"]) == int(jo["info"]["num_isects"])
    assert bool(to["info"]["overflow"]) == bool(jo["info"]["overflow"]) \
        == (cap == 256)
    ni = min(int(jo["info"]["num_isects"]), cap)
    np.testing.assert_array_equal(to["info"]["gauss_ids"].numpy()[:ni],
                                  np.asarray(jo["info"]["gauss_ids"])[:ni])
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   atol=3e-5, rtol=1e-4)


def test_dense_oracle_matches_jax(g):
    s = _scene(7)
    jp = jprojection.project(*[jnp.asarray(s[k]) for k in
                               ("means", "quats", "scales", "viewmat", "K")],
                             WIDTH, HEIGHT, near_plane=0.3)
    cols = np.concatenate([s["colors"], np.asarray(jp.depths)[:, None]], 1)
    ja, jw = jref.rasterize_reference(jp.means2d, jp.conics, jp.depths,
                                      jp.radii, jp.valid,
                                      jnp.asarray(s["opac"]),
                                      jnp.asarray(cols), WIDTH, HEIGHT)
    t = lambda x: torch.from_numpy(np.array(x))
    ta, tw = rasterize_ref.rasterize_reference(
        t(jp.means2d), t(jp.conics), t(jp.depths), t(jp.radii), t(jp.valid),
        t(s["opac"]), t(cols), WIDTH, HEIGHT)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)


def test_probe_and_autotune_match_jax(g):
    n_j = jpipeline.probe_num_isects(*_jax_args(g)[:3], jnp.asarray(
        g["viewmat"]), jnp.asarray(g["K"]), WIDTH, HEIGHT)
    t = _torch_args(g)
    n_t = pipeline.probe_num_isects(t[0], t[1], t[2], t[5], t[6], WIDTH,
                                    HEIGHT)
    assert n_t == n_j == int(g["num_isects"])
    for n in (0, 1000, 200_000, 3_000_001):
        for margin in (1.1, 1.35):
            assert (pipeline.autotune_capacity(n, margin)
                    == jpipeline.autotune_capacity(n, margin))
    assert dataclasses.asdict(pipeline.RasterizeConfig())["tight_radius"]
