"""The port's guards against overflowed Gaussians, held against the JAX
package wherever the JAX package is finite.

A DeformableNodes scale comes from exp(log_scale + the deformation
network's offset); once the network's offset grows past ~88 the scale
overflows to inf, the projection's determinant is NaN, and the JAX
package's gradients (0 * NaN in the conic's VJP, 0 * inf in exp's) turn
every leaf of the class into NaN. The port culls such a Gaussian in the
projection and gives its inputs exactly zero gradients instead; every
output, and every gradient that is finite in the JAX package, is
unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from bilateral_driving_tpu.ops import projection as jprojection
from bilateral_driving_tpu_torch.core import gaussians
from bilateral_driving_tpu_torch.ops import projection
from test_torch_threads import one_torch_thread  # noqa: F401

W, H = 96, 64


def _inputs(n=400, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n),
                      rng.uniform(2, 30, n)], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    log_scales = rng.uniform(-4, 0, (n, 3)).astype(np.float32)
    # overflowed and nearly overflowed scales: exp -> inf, and scales
    # whose squares overflow inside the covariance
    log_scales[:10, 0] = 100.0
    log_scales[10:20] = 45.0
    means[20:25] = np.inf
    view = np.eye(4, dtype=np.float32)
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    return means, quats, log_scales, view, K


def _jax_project(means, quats, log_scales, view, K):
    def f(m, q, ls):
        p = jprojection.project(m, q, jnp.exp(ls), view, K, W, H)
        return p.means2d, p.conics, p.depths
    outs, vjp = jax.vjp(f, jnp.asarray(means), jnp.asarray(quats),
                        jnp.asarray(log_scales))
    p = jprojection.project(jnp.asarray(means), jnp.asarray(quats),
                            jnp.exp(jnp.asarray(log_scales)), view, K, W, H)
    return p, outs, vjp


def test_projection_guard_equals_jax_where_jax_is_finite():
    means, quats, log_scales, view, K = _inputs()
    jp, outs, vjp = _jax_project(means, quats, log_scales, view, K)
    tm, tq, tl = (torch.from_numpy(x).requires_grad_(True)
                  for x in (means, quats, log_scales))
    tp = projection.project(tm, tq, gaussians.finite_grad_exp(tl),
                            torch.from_numpy(view), torch.from_numpy(K),
                            W, H)
    # the same culling: the JAX package culls them too (NaN > 0 is false)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(tp.radii.numpy(), np.asarray(jp.radii))
    assert not tp.valid[:25].any() and tp.valid[25:].sum() > 100
    # the same arithmetic, non-finite values included
    for got, want in ((tp.means2d, jp.means2d), (tp.conics, jp.conics),
                      (tp.depths, jp.depths)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    assert not np.isfinite(np.asarray(jp.conics)[:25]).all()

    # gradients of a loss that reads the projected quantities of the
    # valid Gaussians only, as the rasterizer does
    rng = np.random.default_rng(1)
    cot = [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs]
    valid = np.asarray(jp.valid)
    cot = [c * valid.reshape((-1,) + (1,) * (c.ndim - 1)) for c in cot]
    jg = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cot))]
    loss = sum(torch.sum(o * torch.from_numpy(c)) for o, c in
               zip((tp.means2d, tp.conics, tp.depths), cot))
    tg = torch.autograd.grad(loss, (tm, tq, tl))
    for got, want in zip(tg, jg):
        got = got.numpy()
        assert np.isfinite(got).all()
        fin = np.isfinite(want).all(-1)
        assert not fin[:20].all()      # the JAX gradients are NaN there
        # the pipeline's gradient tolerance (ROADMAP.md): 1e-4 relative
        # norm; the two frameworks form the conic's gradient in other orders
        assert (np.linalg.norm(got[fin] - want[fin])
                <= 1e-4 * np.linalg.norm(want[fin]))
        assert not got[~fin].any()


def test_finite_grad_exp():
    x = torch.tensor([0.5, -2.0, 100.0, 100.0], requires_grad=True)
    y = gaussians.finite_grad_exp(x)
    assert torch.equal(y, torch.exp(x.detach()))
    g = torch.tensor([1.0, 3.0, 0.0, 2.0])
    (gx,) = torch.autograd.grad(y, x, g)
    np.testing.assert_array_equal(gx[:2].numpy(),
                                  (g[:2] * torch.exp(x[:2].detach())).numpy())
    assert gx[2] == 0 and gx[3] == float("inf")
