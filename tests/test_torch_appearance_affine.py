"""The port's affine codes against the JAX package (helpers in
tests/test_torch_appearance.py). Split from that file: the port's test files
hold at most four tests each, bar one parametrized test or tests that share
a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.models import affine as jaffine
from bilateral_driving_tpu.models import camera_opt as jcamera_opt
from bilateral_driving_tpu_torch.models import affine, camera_opt

from test_torch_appearance import (H, N_IMAGES, W, _c2w, _drawn, _parity,
                                   _shapes, _t)
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", ["image", "mean", "pixel"])
def test_affine_mats_match_jax(mode):
    tree = _drawn(_shapes(jaffine.init_affine, N_IMAGES,
                          pixel_affine=mode == "pixel"), 3, sd=0.2)
    pix = np.random.default_rng(4).uniform(0, 1, (H, W, 2)).astype(
        np.float32)
    inputs = (pix,) if mode == "pixel" else ()
    mean = mode == "mean"
    mats = _parity(
        lambda p, *c: jaffine.affine_mats(p, 1, *c, use_mean_embedding=mean),
        lambda p, *c: affine.affine_mats(p, 1, *c, use_mean_embedding=mean),
        tree, *inputs)
    assert mats.shape == ((H, W, 3, 4) if mode == "pixel" else (3, 4))
    _parity(lambda p, *c: jaffine.identity_reg_loss(jaffine.affine_mats(
        p, 2, *c, use_mean_embedding=mean)),
        lambda p, *c: affine.identity_reg_loss(affine.affine_mats(
            p, 2, *c, use_mean_embedding=mean)), tree, *inputs)


def test_zero_pose_embeddings_give_the_same_bits():
    c2w = _c2w(10)
    p = camera_opt.init_camera_opt(torch.Generator().manual_seed(0),
                                   N_IMAGES, device="cpu")
    assert not p["embeds"].any() and p["embeds"].shape == (N_IMAGES, 9)
    out = camera_opt.apply_camera_opt(p, _t(c2w), 1)
    np.testing.assert_array_equal(out.numpy(), c2w)
    jout = jcamera_opt.apply_camera_opt(
        jcamera_opt.init_camera_opt(jax.random.key(0), N_IMAGES),
        jnp.asarray(c2w), 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # the perturbation model draws with std 0.01
    q = camera_opt.init_camera_opt(torch.Generator().manual_seed(0), 4000,
                                   std=0.01, device="cpu")["embeds"]
    assert abs(float(q.std()) - 0.01) < 5e-4
