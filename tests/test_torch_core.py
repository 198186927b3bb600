"""The port's core math against the JAX package: rotations, SH colours and
Gaussian activation, with the origin-safe normalisations' gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.core import sh as jsh
from bilateral_driving_tpu.core import transforms as jtransforms
from bilateral_driving_tpu.scene import background as jbackground
from bilateral_driving_tpu_torch.core import gaussians, sh, transforms
from bilateral_driving_tpu_torch.scene import background


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


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_sh_and_background_activation_match_jax(degree):
    n = 40
    rng = np.random.default_rng(4)
    p = {"means": rng.normal(size=(n, 3)).astype(np.float32),
         "log_scales": rng.normal(-2, 0.5, (n, 3)).astype(np.float32),
         "quats": rng.normal(size=(n, 4)).astype(np.float32),
         "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
         "sh_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
         "sh_rest": rng.normal(0, 0.3, (n, 15, 3)).astype(np.float32)}
    p["means"][0] = 0.0                          # a point at the camera
    mask = (rng.random(n) > 0.2).astype(np.float32)
    cam = np.zeros(3, np.float32)
    step = degree * 1000
    jb = jbackground.gaussians({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(mask), jnp.asarray(cam), step)
    tb = background.gaussians({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(mask), torch.from_numpy(cam),
                              step)
    for name in gaussians.Gaussians._fields:
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(getattr(jb, name)), atol=1e-5,
                                   err_msg=name)
    dirs = _rand(5, n, 3)
    coeffs = np.concatenate([p["sh_dc"], p["sh_rest"]], 1)
    np.testing.assert_allclose(
        sh.eval_sh(torch.from_numpy(coeffs), torch.from_numpy(dirs), degree,
                   3).numpy(),
        np.asarray(jsh.eval_sh(coeffs, dirs, degree, 3)), atol=1e-5)
