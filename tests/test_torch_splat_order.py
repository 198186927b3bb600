"""The EnvLight splat's fixed summation order (csrc/cubemap_splat.cu), on
the CPU: the keys, the stable sort and the run sums in PyTorch
(ops/cubemap_cuda.splat_keys_plain, splat_order, splat_grad_sorted_plain)
and a model of the sum kernel's block walk (its 32-way warp searches, its
chunks of 256 entries and their run heads) against the plain version
(four index_add_ passes) bit for bit and against the texture gradient of
the JAX package's plain sampler at its own tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu_torch.ops import cubemap, cubemap_cuda

from test_torch_backward_splat import _plain_texture_grad
from test_torch_threads import one_torch_thread  # noqa: F401

TEXELS, THREADS = 1024, 256       # the sum kernel's block and chunk


def _inputs(kind: str, res: int, h: int = 48, w: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        gx, gy = np.meshgrid(np.linspace(-0.3, 0.3, w),
                             np.linspace(-0.2, 0.2, h))
        dirs = np.stack([gx, gy, np.ones_like(gx)], -1).astype(np.float32)
    else:
        dirs = rng.normal(size=(h, w, 3)).astype(np.float32)
    g = rng.normal(size=(h * w, 3)).astype(np.float32)
    g[rng.random(h * w) < 0.25] = 0.0          # pixels with no cotangent
    face, u0, v0, fu, fv = cubemap.corner_data(torch.from_numpy(dirs), res)
    face = face.clone()
    face[rng.random(h * w) < 0.1] = -1         # padding
    return dirs, (face, u0, v0, fu, fv, torch.from_numpy(g))


def _warp_lower_bound(keys: np.ndarray, x: int) -> int:
    """csrc/cubemap_splat.cu's warp_lower_bound, lane by lane."""
    lo, hi = 0, keys.shape[0]
    while hi - lo > 32:
        stride = (hi - lo) // 32
        k = sum(int(keys[lo + (lane + 1) * stride - 1] < x)
                for lane in range(32))
        if k < 32:
            hi = lo + (k + 1) * stride - 1
        lo += k * stride
    return lo + sum(int(lo + lane < hi and keys[lo + lane] < x)
                    for lane in range(32))


def _sum_kernel_model(keys, order, fu, fv, g, res: int) -> np.ndarray:
    """splat_sum_kernel block by block: each block's entries by its two
    searches, chunks of THREADS entries whose run heads add their runs, in
    float32 rounding, onto the texels' running sums."""
    keys, order = keys.numpy(), order.numpy()
    fu, fv, g = fu.numpy(), fv.numpy(), g.numpy()
    npix, n_tex = fu.shape[0], 6 * res * res
    one = np.float32(1.0)
    out = np.zeros((n_tex, 3), np.float32)
    for t0 in range(0, n_tex, TEXELS):
        t1 = min(t0 + TEXELS, n_tex)
        lo, hi = _warp_lower_bound(keys, t0), _warp_lower_bound(keys, t1)
        s_out = np.zeros((TEXELS, 3), np.float32)
        for c0 in range(lo, hi, THREADS):
            j = np.arange(c0, min(c0 + THREADS, hi))
            e = order[j]
            corner, p = e // npix, e % npix
            a = np.where(corner & 2, fv[p], one - fv[p])
            b = np.where(corner & 1, fu[p], one - fu[p])
            vals = (g[p] * a[:, None]) * b[:, None]
            # the run heads' adds, entry after entry (np.add.at adds
            # unbuffered, in index order)
            np.add.at(s_out, keys[j] - t0, vals)
        out[t0:t1] = s_out[:t1 - t0]
    return out.reshape(6, res, res, 3)


@pytest.mark.parametrize("kind,res", [("smooth", 8), ("smooth", 64),
                                      ("random", 16)])
def test_splat_order_equals_index_add_and_jax(kind, res):
    """R=8 and smooth rays put hundreds of entries on one texel (runs over
    several chunks); random rays spread them over every face."""
    dirs, (face, u0, v0, fu, fv, g) = _inputs(kind, res)
    keys = cubemap_cuda.splat_keys_plain(face, u0, v0, g, res)
    assert keys.dtype == torch.int32 and keys.shape == (4 * g.shape[0],)
    skeys, order = cubemap_cuda.splat_order(keys)
    # each texel's run goes corner by corner, pixel by pixel
    same = skeys[1:] == skeys[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    want = cubemap_cuda.splat_grad_plain(face, u0, v0, fu, fv, g, res)
    got = cubemap_cuda.splat_grad_sorted_plain(skeys, order, fu, fv, g, res)
    assert torch.equal(got, want)
    model = _sum_kernel_model(skeys, order, fu, fv, g, res)
    np.testing.assert_array_equal(model, want.numpy())
    runs = torch.unique_consecutive(skeys[skeys < 6 * res * res],
                                    return_counts=True)[1]
    if res == 8:
        assert int(runs.max()) > THREADS       # a run spans chunks

    # against the texture gradient of the JAX package's plain sampler on
    # the same rays (tests/test_cubemap.py holds its Pallas splat to it):
    # its weights round elsewhere (tests/test_torch_backward_splat.py)
    h, w = dirs.shape[:2]
    gj = np.where((face >= 0).numpy()[:, None], g.numpy(), 0.0)
    jax_want = np.asarray(_plain_texture_grad(
        jnp.zeros((6, res, res, 3)), jnp.asarray(dirs),
        jnp.asarray(gj.reshape(h, w, 3), jnp.float32)))
    np.testing.assert_allclose(model, jax_want,
                               atol=2e-5 * np.abs(jax_want).max())


def test_warp_lower_bound_model():
    rng = np.random.default_rng(1)
    for n in (0, 1, 31, 32, 33, 1000, 5000):
        keys = np.sort(rng.integers(0, 300, n)).astype(np.int32)
        for x in (0, 1, 150, 299, 300, 301):
            assert _warp_lower_bound(keys, x) == np.searchsorted(keys, x)
