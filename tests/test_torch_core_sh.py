"""The port's SH colours and background activation against the JAX package
(helpers in tests/test_torch_core.py). Split from that file: the port's test
files hold at most four tests each, bar one parametrized test or tests that
share a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.core import sh as jsh
from bilateral_driving_tpu.scene import background as jbackground
from bilateral_driving_tpu_torch.core import gaussians, sh
from bilateral_driving_tpu_torch.scene import background

from test_torch_core import _rand
from test_torch_threads import one_torch_thread  # noqa: F401


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
