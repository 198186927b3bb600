"""The port's core math against the JAX package: rotations, SH colours and
Gaussian activation, with the origin-safe normalisations' gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.core import transforms as jtransforms
from bilateral_driving_tpu_torch.core import transforms
from test_torch_threads import one_torch_thread  # noqa: F401


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_rotations_match_jax():
    q0, q1 = _rand(0, 50, 4), _rand(1, 50, 4)
    q1[:5] = q0[:5] * 1.0001                      # the nearly-parallel lerp
    t = lambda x: torch.from_numpy(x)
    np.testing.assert_allclose(transforms.quat_to_rotmat(t(q0)).numpy(),
                               np.asarray(jtransforms.quat_to_rotmat(q0)),
                               atol=1e-6)
    np.testing.assert_allclose(transforms.quat_mult(t(q0), t(q1)).numpy(),
                               np.asarray(jtransforms.quat_mult(q0, q1)),
                               atol=1e-5)
    np.testing.assert_allclose(transforms.quat_slerp(t(q0), t(q1), 0.5).numpy(),
                               np.asarray(jtransforms.quat_slerp(q0, q1, 0.5)),
                               atol=1e-5)


@pytest.mark.parametrize("fn", ["safe_norm", "safe_normalize"])
def test_safe_norms_and_their_gradients_at_the_origin(fn):
    x = _rand(2, 6, 3)
    x[0] = 0.0
    jf = getattr(jtransforms, fn)
    tf = getattr(transforms, fn)
    np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                               np.asarray(jf(x)), atol=1e-6)
    w = _rand(3, *np.asarray(jf(x)).shape)
    jg = jax.grad(lambda v: jnp.sum(jf(v) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(tf(xt) * torch.from_numpy(w)).backward()
    assert np.isfinite(xt.grad.numpy()).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
