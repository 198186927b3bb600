"""The port's rasterization pipeline against the JAX package: the committed
goldens, projection and binning integers, overflow truncation, the dense
oracle and capacity probing."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import binning as jbinning
from bilateral_driving_tpu.ops import expand_pallas as jexpand
from bilateral_driving_tpu.ops import projection as jprojection
from bilateral_driving_tpu_torch.ops import (binning, expand_cuda, pipeline,
                                             projection)
from test_torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "fixtures",
                       "goldens_rasterize.npz")
WIDTH, HEIGHT = 96, 64
KEYS = ("means", "quats", "scales", "opac", "colors", "viewmat", "K")


@pytest.fixture(scope="module")
def g():
    return dict(np.load(GOLDENS))


def _torch_args(g):
    return [torch.from_numpy(g[k]) for k in KEYS]


def _jax_args(g):
    return [jnp.asarray(g[k]) for k in KEYS]


@pytest.mark.parametrize("tight", [False, True])
def test_render_matches_golden(g, tight):
    out = pipeline.rasterize(*_torch_args(g), WIDTH, HEIGHT,
                             pipeline.RasterizeConfig(isect_capacity=2 ** 14,
                                                      tight_radius=tight))
    # the goldens' count is the plain 3-sigma AABB one; the opacity-aware
    # radius of this scene drops no entry
    assert int(out["info"]["num_isects"]) == int(g["num_isects"])
    assert not bool(out["info"]["overflow"])
    np.testing.assert_allclose(out["rgb"].numpy(), g["rgb"], atol=3e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(out["alpha"].numpy()[..., 0], g["alpha"],
                               atol=3e-5, rtol=1e-4)
    hit = g["alpha"] > 0.2
    np.testing.assert_allclose(out["depth"].numpy()[..., 0][hit],
                               g["depth"][hit], atol=1e-3, rtol=1e-4)


def _scene(seed, n=300, near_frac=0.1):
    """Random scene with some Gaussians behind or at the near plane and
    some off the image."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(0.5, 12, n)], 1).astype(np.float32)
    means[: int(n * near_frac), 2] = rng.uniform(-1, 0.2, int(n * near_frac))
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1, (n, 3))).astype(np.float32)
    opac = rng.uniform(0.02, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.1, -0.2, 0.3]
    K = np.array([[70.0, 0, 47], [0, 70.0, 33], [0, 0, 1]], np.float32)
    return dict(zip(KEYS, (means, quats, scales, opac, colors, view, K)))


@pytest.mark.parametrize("which", ["goldens", "near_plane"])
def test_projection_and_binning_integers_equal_jax(g, which):
    s = g if which == "goldens" else _scene(3)
    near = 0.01 if which == "goldens" else 0.3
    jp = jprojection.project(*[jnp.asarray(s[k]) for k in
                               ("means", "quats", "scales", "viewmat", "K")],
                             WIDTH, HEIGHT, near_plane=near)
    tp = projection.project(*[torch.from_numpy(s[k]) for k in
                              ("means", "quats", "scales", "viewmat", "K")],
                            WIDTH, HEIGHT, near_plane=near)
    np.testing.assert_array_equal(np.asarray(jp.radii), tp.radii.numpy())
    np.testing.assert_array_equal(np.asarray(jp.valid), tp.valid.numpy())
    for name in ("means2d", "conics", "depths"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-6, atol=1e-6)

    jsp = jbinning.spans(jp.means2d, jp.radii, jp.valid, WIDTH, HEIGHT)
    tsp = binning.spans(tp.means2d, tp.radii, tp.valid, WIDTH, HEIGHT)
    for a, b in zip(jsp, tsp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    cap = 4096
    jex = jbinning.expand_light(jsp.counts, cap)
    tex = binning.expand_light(tsp.counts, cap)
    np.testing.assert_array_equal(np.asarray(jex.offsets), tex.offsets.numpy())
    assert int(jex.num_isects) == int(tex.num_isects) > 0

    # key -> sort (gid tie-break) -> tile ranges
    n = s["means"].shape[0]
    ntx, nty = binning.num_tiles(WIDTH, HEIGHT)
    rows = lambda sp, ex, p: [sp.tx0, sp.ty0, sp.span_w, ex.offsets[:-1],
                              p.depths]
    jtab = jnp.zeros((16, n), jnp.float32)
    for i, r in zip((0, 1, 2, 3, 13), rows(jsp, jex, jp)):
        jtab = jtab.at[i].set(r.astype(jnp.float32))
    jtab = jtab.at[14].set(jnp.arange(n, dtype=jnp.float32))
    jkey, jgid, _ = jexpand.expand_gather_xla(jtab, jex.offsets,
                                              jex.num_isects, cap, ntx,
                                              ntx * nty, n)
    jkey_s, jgid_s = jax.lax.sort((jkey, jgid), num_keys=2)
    jstarts, jcounts = jbinning.tile_ranges(
        jbinning.tiles_of_keys(jkey_s, ntx * nty), jex.num_isects,
        ntx * nty, cap)
    ttab = torch.from_numpy(np.array(jtab))
    tkey, tgid, _ = expand_cuda.expand_gather(ttab, tex.offsets,
                                              tex.num_isects, cap, ntx,
                                              ntx * nty, n)
    tkey_s, perm = torch.sort(tkey, stable=True)
    tstarts, tcounts = binning.tile_ranges(
        binning.tiles_of_keys(tkey_s, ntx * nty), tex.num_isects, ntx * nty,
        cap)
    np.testing.assert_array_equal(np.asarray(jkey_s), tkey_s.numpy())
    np.testing.assert_array_equal(np.asarray(jgid_s), tgid[perm].numpy())
    np.testing.assert_array_equal(np.asarray(jstarts), tstarts.numpy())
    np.testing.assert_array_equal(np.asarray(jcounts), tcounts.numpy())
