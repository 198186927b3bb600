"""The port's EnvLight splat against the Pallas kernel in interpret mode (the
port's one comparison with that kernel), and its texture layout against the
JAX package's plain sampler (helpers in tests/test_torch_backward.py).
Split from that file: the port's test files hold at most four tests each,
bar one parametrized test or tests that share a module fixture, so that
pytest-xdist's count-ordered queue (--dist loadfile) runs them after
tests/test_parallel.py (README).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import cubemap as jcubemap
from bilateral_driving_tpu_torch.ops import cubemap, cubemap_cuda

from test_torch_backward import _smooth_dirs
from test_torch_threads import one_torch_thread  # noqa: F401


@jax.jit
def _plain_texture_grad(base, dirs, g):
    """The texture gradient of the JAX package's plain bilinear cube sampler
    `cubemap.sample` (tests/test_cubemap.py holds its Pallas splat to it)."""
    return jax.vjp(lambda b: jcubemap.sample(b, dirs), base)[1](g)[0]


@pytest.mark.parametrize("dirs_kind", ["smooth", "random"])
def test_splat_grad_matches_pallas_kernel(dirs_kind):
    """R=128: smooth rays take the TPU kernel's window path, random ones
    its scatter fallback."""
    res = 128
    rng = np.random.default_rng(3)
    dirs = (_smooth_dirs(64, 64) if dirs_kind == "smooth"
            else rng.normal(size=(64, 64, 3)).astype(np.float32))
    g = rng.normal(size=(64, 64, 3)).astype(np.float32)
    base = rng.uniform(0, 1, (6, res, res, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda b: jcubemap.sample_splat_vjp(
        b, jnp.asarray(dirs), True), jnp.asarray(base))
    want = np.asarray(vjp(jnp.asarray(g))[0])

    tb = torch.from_numpy(base).requires_grad_(True)
    out = cubemap.sample_splat(tb, torch.from_numpy(dirs))
    # texel coordinates (u / 2 + 1/2) R - 1/2 round at about R 2^-24 =
    # 8e-6 at R=128, in other places in the two frameworks, so bilinear
    # weights (and with them values and gradients) differ by up to ~1e-5
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jcubemap.sample(jnp.asarray(base), jnp.asarray(dirs))),
        atol=2e-5)
    (got,) = torch.autograd.grad(out, tb, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-5 * np.abs(want).max())

    # padded pixels (face -1) add nothing
    face, u0, v0, fu, fv = cubemap.corner_data(torch.from_numpy(dirs), res)
    face = face.clone()
    face[::2] = -1
    dz = cubemap_cuda.splat_grad(face, u0, v0, fu, fv,
                            torch.from_numpy(g.reshape(-1, 3)), res)
    keep = slice(1, None, 2)
    dz_odd = cubemap_cuda.splat_grad(face[keep], u0[keep], v0[keep], fu[keep],
                                fv[keep], torch.from_numpy(
                                    g.reshape(-1, 3)[1::2].copy()), res)
    torch.testing.assert_close(dz, dz_odd, rtol=0, atol=0)


@pytest.mark.parametrize("dirs_kind", ["smooth", "random"])
def test_splat_gradient_has_the_texture_layout(dirs_kind):
    """sample_splat's texture gradient comes in the texture's own shape and
    strides ((6, R, R, 3) contiguous, what the optimizer is handed as
    base.grad) and equals the JAX VJP, at R=128: the VJP of the JAX
    package's plain `sample` (tests/test_cubemap.py holds its Pallas splat
    to it; test_splat_grad_matches_pallas_kernel holds the port to that
    kernel)."""
    res = 128
    rng = np.random.default_rng(4)
    dirs = (_smooth_dirs(48, 80) if dirs_kind == "smooth"
            else rng.normal(size=(48, 80, 3)).astype(np.float32))
    g = rng.normal(size=(48, 80, 3)).astype(np.float32)
    base = rng.uniform(0, 1, (6, res, res, 3)).astype(np.float32)
    want = np.asarray(_plain_texture_grad(base, dirs, g))

    tb = torch.from_numpy(base).requires_grad_(True)
    cubemap.sample_splat(tb, torch.from_numpy(dirs)).backward(
        torch.from_numpy(g))
    assert tb.grad.shape == tb.shape and tb.grad.stride() == tb.stride()
    assert tb.grad.is_contiguous()
    # as in test_splat_grad_matches_pallas_kernel: bilinear weights round
    # differently in the two frameworks by up to ~1e-5
    np.testing.assert_allclose(tb.grad.numpy(), want,
                               atol=2e-5 * np.abs(want).max())
    face, u0, v0, fu, fv = cubemap.corner_data(torch.from_numpy(dirs), res)
    dz = cubemap_cuda.splat_grad(face, u0, v0, fu, fv,
                                 torch.from_numpy(g.reshape(-1, 3)), res)
    assert dz.shape == (6, res, res, 3) and dz.is_contiguous()
    torch.testing.assert_close(dz, tb.grad, rtol=0, atol=0)
