"""The port's sinusoidal encoding, 6-D rotations and camera refinement against
the JAX package (helpers in tests/test_torch_appearance.py). Split from that
file: the port's test files hold at most four tests each, bar one
parametrized test or tests that share a module fixture, so that pytest-
xdist's count-ordered queue (--dist loadfile) runs them after
tests/test_parallel.py (README).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.core import transforms as jtransforms
from bilateral_driving_tpu.models import camera_opt as jcamera_opt
from bilateral_driving_tpu.models import encoders as jencoders
from bilateral_driving_tpu_torch.core import transforms
from bilateral_driving_tpu_torch.models import camera_opt
from bilateral_driving_tpu_torch.models import encoders

from test_torch_appearance import N_IMAGES, _c2w, _drawn, _parity, _shapes, _t
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("use_identity", [True, False])
def test_sinusoidal_encode_matches_jax(use_identity):
    x = np.random.default_rng(2).uniform(-1, 1, (5, 3)).astype(np.float32)
    out = _parity(lambda _, x: jencoders.sinusoidal_encode(
        x, 0, 4, use_identity),
        lambda _, x: encoders.sinusoidal_encode(x, 0, 4, use_identity),
        {}, x)
    assert out.shape[-1] == encoders.sinusoidal_dim(3, 0, 4, use_identity) \
        == jencoders.sinusoidal_dim(3, 0, 4, use_identity)
    same = encoders.sinusoidal_encode(_t(x), 2, 2)
    assert torch.equal(same, _t(x))


def test_rotation_6d_matches_jax():
    d6 = np.random.default_rng(5).normal(size=(7, 6)).astype(np.float32)
    rot = _parity(lambda _, d: jtransforms.rotation_6d_to_matrix(d),
                  lambda _, d: transforms.rotation_6d_to_matrix(d), {}, d6)
    eye = torch.eye(3).expand(7, 3, 3)
    torch.testing.assert_close(rot @ rot.transpose(-1, -2), eye)
    R = np.random.default_rng(6).normal(size=(2, 3, 3)).astype(np.float32)
    t = np.random.default_rng(7).normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        transforms.se3_compose(_t(R), _t(t)).numpy(),
        np.asarray(jtransforms.se3_compose(jnp.asarray(R), jnp.asarray(t))))


def test_apply_camera_opt_matches_jax():
    tree = _drawn(_shapes(jcamera_opt.init_camera_opt, N_IMAGES), 8,
                  sd=0.1)
    _parity(lambda p, c: jcamera_opt.apply_camera_opt(p, c, 2),
            lambda p, c: camera_opt.apply_camera_opt(p, c, 2), tree,
            _c2w(9))
