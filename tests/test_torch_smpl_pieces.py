"""The port's blended-rotation gradient, pose loader, single bilateral grid and
the voxel deformer's raise against the JAX package (helpers in
tests/test_torch_smpl.py). Split from that file: the port's test files hold
at most four tests each, bar one parametrized test or tests that share a
module fixture, so that pytest-xdist's count-ordered queue (--dist loadfile)
runs them after tests/test_parallel.py (README).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.core import transforms as jtransforms
from bilateral_driving_tpu.data import scene as jscene
from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu_torch import configs
from bilateral_driving_tpu_torch.core import transforms
from bilateral_driving_tpu_torch.data import scene
from bilateral_driving_tpu_torch.models import bilateral
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.train import trainer
from bilateral_driving_tpu_torch.utils import config

from test_torch_smpl import EPS, SCENE, _rel, _t
from test_torch_threads import one_torch_thread  # noqa: F401


def test_rotmat_to_quat_gradient_on_blended_rotations():
    """rotmat_to_quat differentiated at non-orthonormal matrices (blends of
    rotations, as LBS makes them), with every one of the four candidates
    selected somewhere and negative w flipped."""
    rng = np.random.default_rng(6)
    qa = rng.normal(size=(400, 4)).astype(np.float32)
    qb = rng.normal(size=(400, 4)).astype(np.float32)
    t = rng.uniform(0, 1, (400, 1, 1)).astype(np.float32)
    ra = np.asarray(jtransforms.quat_to_rotmat(jnp.asarray(qa)))
    rb = np.asarray(jtransforms.quat_to_rotmat(jnp.asarray(qb)))
    m = ((1 - t) * ra + t * rb).astype(np.float32)
    diag = np.stack([1 + np.trace(m, axis1=1, axis2=2),
                     1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                     1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2],
                     1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], -1)
    assert set(np.argmax(diag, -1)) == {0, 1, 2, 3}
    w = rng.normal(size=(400, 4)).astype(np.float32)
    x = _t(m).requires_grad_(True)
    q = transforms.rotmat_to_quat(x)
    (g,) = torch.autograd.grad((q * _t(w)).sum(), x)
    jq, jg = jax.value_and_grad(lambda a: jnp.sum(
        jtransforms.rotmat_to_quat(a) * jnp.asarray(w)))(jnp.asarray(m))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(
        jtransforms.rotmat_to_quat(jnp.asarray(m))), atol=4 * EPS, rtol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)


def test_load_smpl_poses_matches_jax():
    """quats to 2 ulp (rotmat_to_quat's rsqrt, ROADMAP.md), betas and
    validity exactly, on the fixture's one pedestrian over 30 frames."""
    frames = list(range(30))
    inv_first = np.linalg.inv(np.loadtxt(os.path.join(
        SCENE, "extrinsics", "000_0.txt")))
    want = jscene.load_smpl_poses(SCENE, frames, inv_first)
    got = scene.load_smpl_poses(SCENE, frames, inv_first)
    assert set(got) == set(want) and len(got) == 1
    for iid, w in want.items():
        g = got[iid]
        assert g["valid"].sum() > 20
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_array_equal(g["betas"], w["betas"])
        np.testing.assert_allclose(g["quats"], w["quats"], atol=2 * EPS,
                                   rtol=0)


def test_single_grid_matches_jax():
    """bilateral_affines with and without neighbour averaging (the
    16 x 16 x 8 grid is sliced by gathers on both sides) and the TV loss,
    values and gradients by the grids."""
    rng = np.random.default_rng(8)
    grids = rng.normal(1, 0.3, (5, 12, 8, 16, 16)).astype(np.float32)
    rgb = rng.uniform(0, 1, (17, 23, 3)).astype(np.float32)
    w = rng.normal(size=(17, 23, 3, 4)).astype(np.float32)
    for nbrs in (None, [0, 3]):
        tg = _t(grids).requires_grad_(True)
        mats = bilateral.bilateral_affines({"grids": tg}, _t(rgb), 2,
                                           neighbor_idx=nbrs)
        (g,) = torch.autograd.grad((mats * _t(w)).sum(), tg)

        def jf(gr):
            return jnp.sum(jbilateral.bilateral_affines(
                {"grids": gr}, jnp.asarray(rgb), 2,
                neighbor_idx=None if nbrs is None else jnp.asarray(nbrs))
                * jnp.asarray(w))

        jm = jbilateral.bilateral_affines(
            {"grids": jnp.asarray(grids)}, jnp.asarray(rgb), 2,
            neighbor_idx=None if nbrs is None else jnp.asarray(nbrs))
        np.testing.assert_allclose(mats.detach().numpy(), np.asarray(jm),
                                   atol=1e-5, rtol=1e-5)
        assert _rel(g.numpy(), jax.grad(jf)(jnp.asarray(grids))) < 1e-5
    tg = _t(grids).requires_grad_(True)
    tv = bilateral.bilateral_tv_loss({"grids": tg})
    (g,) = torch.autograd.grad(tv, tg)
    jtv, jg = jax.value_and_grad(lambda gr: jbilateral.bilateral_tv_loss(
        {"grids": gr}))(jnp.asarray(grids))
    # a float32 sum of 110,400 squared differences in other orders
    np.testing.assert_allclose(float(tv), float(jtv), rtol=1e-4)
    assert _rel(g.numpy(), jg) < 1e-5
    init = bilateral.init_bilateral(4, device="cpu")["grids"]
    np.testing.assert_array_equal(init.numpy(), np.asarray(
        jbilateral.init_bilateral(None, 4)["grids"]))


def test_voxel_deformer_names_its_slice():
    cfg = common.trainer_config_from(config.apply_dotlist(
        config.wrap(configs.OMNIRE_BILATERAL_TREE),
        ["trainer.use_voxel_deformer=true"]), 1, 1, 1.0)
    with pytest.raises(NotImplementedError, match="voxel-deformer slice"):
        trainer.collect_gaussians(cfg, {}, {}, {}, torch.zeros(3), 0, 0, 0.0)
    cfg = common.trainer_config_from(config.apply_dotlist(
        config.wrap(configs.OMNIRE_BILATERAL_TREE),
        ["trainer.sky_model=mlp"]), 1, 1, 1.0)
    with pytest.raises(NotImplementedError, match="sky-MLP slice"):
        trainer.collect_gaussians(cfg, {}, {}, {}, torch.zeros(3), 0, 0, 0.0)
