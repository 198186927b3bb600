"""The port's multi-scale neural and CP-4D grids against the JAX package
(helpers in tests/test_torch_appearance.py). Split from that file: the
port's test files hold at most four tests each, bar one parametrized test or
tests that share a module fixture, so that pytest-xdist's count-ordered
queue (--dist loadfile) runs them after tests/test_parallel.py (README).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu_torch.models import bilateral

from test_torch_appearance import (H, NEIGHBOURS, N_IMAGES, W, _drawn, _images,
                                   _parity, _shapes)
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("nbrs", NEIGHBOURS, ids=["image", "neighbours"])
def test_multiscale_neural_matches_jax(nbrs):
    tree = _drawn(_shapes(jbilateral.init_multiscale_neural, N_IMAGES,
                          hidden_dim=16), 14)
    jn = None if nbrs is None else jnp.asarray(nbrs)
    _parity(lambda p, rgb: jbilateral.multiscale_neural_affines(
        p, rgb, 2, neighbor_idx=jn),
        lambda p, rgb: bilateral.multiscale_neural_affines(
            p, rgb, 2, neighbor_idx=nbrs), tree, _images(15))
    tv_tree = {"levels": [{"grids": lv["grids"]} for lv in tree["levels"]]}
    _parity(jbilateral.multiscale_neural_tv_loss,
            bilateral.multiscale_tv_loss, tv_tree)


def test_cp4d_matches_jax():
    tree = _drawn(_shapes(jbilateral.init_cp4d, rank=3, grid_x=6, grid_y=5,
                          grid_z=4, grid_w=3), 16, sd=0.5)
    rng = np.random.default_rng(17)
    # coordinates past both ends too: the clamp at the border
    xyz = rng.uniform(-1.2, 1.2, (H, W, 3)).astype(np.float32)
    _parity(lambda p, x, rgb: jbilateral.cp4d_affines(p, x, rgb),
            lambda p, x, rgb: bilateral.cp4d_affines(p, x, rgb), tree, xyz,
            _images(18))
    _parity(jbilateral.cp4d_tv_loss, bilateral.cp4d_tv_loss, tree)


def test_cp4d_init_is_the_identity():
    p = bilateral.init_cp4d(torch.Generator().manual_seed(0), device="cpu")
    jp = _shapes(jbilateral.init_cp4d)
    ident = torch.tensor([1.0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0])
    for k in ("fx", "fy", "fz", "fw"):
        assert p[k].shape == jp[k].shape
        # rank 0 carries the identity, the JAX package's closed form
        want = ident if k == "fw" else torch.ones(12)
        assert torch.equal(p[k][0], want.expand_as(p[k][0]))
        assert 5e-4 < float(p[k][1:].std()) < 2e-3
    zero = {k: torch.cat([v[:1], torch.zeros_like(v[1:])]) for k, v in
            p.items()}
    xyz = torch.rand((4, 5, 3)) * 2 - 1
    mats = bilateral.cp4d_affines(zero, xyz, torch.rand((4, 5, 3)))
    torch.testing.assert_close(mats, torch.eye(3, 4).expand(4, 5, 3, 4))
