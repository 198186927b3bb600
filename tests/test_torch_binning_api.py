"""The port's standalone binning (ops/binning.py: bin_gaussians, expand,
quantize_depth_like_sort) and core/transforms.py's 6D, point, SE(3)
inverse and pose-interpolation helpers against the JAX package's.

bin_gaussians takes the JAX package's projection of ~500 Gaussians made
as tests/test_rasterize.py::TestBinning makes them, drawn here from a
numpy seed. Counts, starts, offsets and owning tiles are bit-equal; the
JAX sort is not stable, so each tile's Gaussian ids are compared as
sorted by (depth key, id), which is the port's own order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.core import transforms as jtransforms
from bilateral_driving_tpu.ops import binning as jbinning
from bilateral_driving_tpu.ops import projection as jprojection
from bilateral_driving_tpu_torch.core import transforms
from bilateral_driving_tpu_torch.ops import binning
from test_torch_threads import one_torch_thread  # noqa: F401

W, H = 96, 64
TRANSFORM_ATOL = 1e-6


def _projected(n: int = 500, seed: int = 6):
    """The JAX projection of test_rasterize.py's scene recipe: means in
    [-1.2, 1.2]^2 x [2, 8], random rotations, scales exp U(-3.5, -1.5),
    identity view, focal 0.8 W; as numpy."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                            rng.uniform(2.0, 8.0, (n, 1))], 1)
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(rng.uniform(-3.5, -1.5, (n, 3)))
    f = 0.8 * W
    K = np.array([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]])
    p = jprojection.project(*(jnp.asarray(x, jnp.float32) for x in
                              (means, quats, scales, np.eye(4), K)), W, H)
    return [np.array(x) for x in (p.means2d, p.radii, p.depths, p.valid)]


@pytest.mark.parametrize("cap", [2 ** 14, 600])
def test_bin_gaussians_matches_jax(cap):
    """At a capacity that holds every entry and at one the entries
    overflow (truncated at cap in both)."""
    args = _projected()
    want = jax.jit(jbinning.bin_gaussians, static_argnums=(4, 5, 6))(
        *(jnp.asarray(a) for a in args), W, H, cap)
    got = binning.bin_gaussians(*(torch.from_numpy(a) for a in args), W, H,
                                cap)
    for k in ("num_isects", "overflow", "offsets", "tile_counts",
              "tile_starts", "isect_tile"):
        w = np.asarray(getattr(want, k))
        g = getattr(got, k).numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    m = int(got.num_isects)
    assert bool(got.overflow) == (m > cap) and m > 600
    qdepth = binning.quantize_depth_like_sort(torch.from_numpy(args[2]),
                                              got.tile_counts.numel()).numpy()
    jids, tids = np.asarray(want.gauss_ids), got.gauss_ids.numpy()
    for s, c in zip(got.tile_starts.tolist(), got.tile_counts.tolist()):
        j, t = jids[s:s + c], tids[s:s + c]
        # the JAX order wherever the keys differ, the same ids per key
        np.testing.assert_array_equal(qdepth[j], qdepth[t])
        np.testing.assert_array_equal(j[np.lexsort((j, qdepth[j]))], t)
    # each sorted entry's expansion index names its Gaussian
    sp = binning.spans(*(torch.from_numpy(args[i]) for i in (0, 1, 3)), W, H)
    g = binning.expand(sp.counts, cap).g.numpy()
    n = min(m, cap)
    np.testing.assert_array_equal(g[got.eidx.numpy()[:n]], tids[:n])


def test_expand_and_depth_quantization_match_jax():
    """expand on counts with empty segments, below and past capacity, and
    quantize_depth_like_sort on depths with zeros and negatives, at tile
    counts of 1 to 2^12 tiles: bit-equal."""
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 6, 400).astype(np.int32)
    counts[rng.random(400) < 0.3] = 0
    for cap in (4096, 700, 1):
        want = jbinning.expand(jnp.asarray(counts), cap)
        got = binning.expand(torch.from_numpy(counts), cap)
        for k in want._fields:
            w, g = np.asarray(getattr(want, k)), getattr(got, k).numpy()
            assert g.dtype == w.dtype, (cap, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{cap} {k}")
    depths = np.concatenate([rng.uniform(0.01, 200.0, 300),
                             [0.0, -0.0, -1.5, 1e-30, 3e38]]
                            ).astype(np.float32)
    for n_tiles in (1, 15, 120, 4096):
        want = np.asarray(jbinning.quantize_depth_like_sort(
            jnp.asarray(depths), n_tiles))
        got = binning.quantize_depth_like_sort(torch.from_numpy(depths),
                                               n_tiles).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_transform_helpers_match_jax():
    """matrix_to_rotation_6d, transform_points (a batch of poses over N
    points each), se3_inverse and interpolate_poses on poses from a numpy
    seed, within TRANSFORM_ATOL."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 5, 4)).astype(np.float32)
    t = rng.normal(size=(2, 5, 3)).astype(np.float32)
    pts = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    jT = jtransforms.se3_compose(jtransforms.quat_to_rotmat(jnp.asarray(q)),
                                 jnp.asarray(t))
    T = torch.from_numpy(np.array(jT))
    pairs = [
        (transforms.matrix_to_rotation_6d(T[..., :3, :3]),
         jtransforms.matrix_to_rotation_6d(jT[..., :3, :3])),
        (transforms.transform_points(T, torch.from_numpy(pts)),
         jtransforms.transform_points(jT, jnp.asarray(pts))),
        (transforms.se3_inverse(T), jtransforms.se3_inverse(jT)),
    ] + [(transforms.interpolate_poses(T[0], T[1], s),
          jtransforms.interpolate_poses(jT[0], jT[1], s))
         for s in (0.0, 0.3, 1.0)]
    for i, (got, want) in enumerate(pairs):
        assert got.shape == want.shape, i
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TRANSFORM_ATOL, err_msg=str(i))
    eye = transforms.se3_inverse(T) @ T
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(
        np.eye(4), eye.shape), atol=1e-5)
