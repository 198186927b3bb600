"""The port's blended-rotation gradient, pose loader, single bilateral grid and
the SMPL means through the voxel deformer against the JAX package (helpers in
tests/test_torch_smpl.py). Split from that file: the port's test files hold
at most four tests each, bar one parametrized test or tests that share a
module fixture, so that pytest-xdist's count-ordered queue (--dist loadfile)
runs them after tests/test_parallel.py (README).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.core import transforms as jtransforms
from bilateral_driving_tpu.data import scene as jscene
from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu.models import encoders as jencoders
from bilateral_driving_tpu.scene import smpl_model as jsmpl_model
from bilateral_driving_tpu.scene import voxel_deformer as jvd
from bilateral_driving_tpu.train import trainer as jtrainer
from bilateral_driving_tpu_torch import configs
from bilateral_driving_tpu_torch.core import transforms
from bilateral_driving_tpu_torch.data import scene
from bilateral_driving_tpu_torch.models import bilateral
from bilateral_driving_tpu_torch.scene import smpl_model
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.train import setup, trainer
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
    """collect_gaussians with the voxel skinning deformer on gives the JAX
    package's SMPL means (atol 1e-5): two pedestrians of the port's
    64-vertex synthetic body built by setup.build_smpl with the deformer,
    its correction off zero, posed at a frame with perturbed joints,
    beside a small Background; the same arrays handed to the JAX
    package's jitted collect_gaussians."""
    g = torch.Generator().manual_seed(4)
    F, I, V = 3, 2, 64
    model = smpl_model.synthetic_model(g, num_verts=V, device="cpu")
    da = smpl_model.da_pose_quats(device="cpu")
    sp, ss, sa, sm = setup.build_smpl(
        g, model, torch.randn((I, 10), generator=g),
        da[0].expand(F, I, 1, 4) + 0.1 * torch.randn((F, I, 1, 4),
                                                     generator=g),
        da[1:].expand(F, I, 23, 4) + 0.1 * torch.randn((F, I, 23, 4),
                                                       generator=g),
        torch.randn((F, I, 3), generator=g) + torch.tensor([0, 0, 8.0]),
        torch.ones((F, I), dtype=torch.bool), use_voxel_deformer=True)
    sp["voxel_w_correction"] += 0.02 * torch.randn(
        sp["voxel_w_correction"].shape, generator=g)
    bp, bm = setup.build_background(
        g, 64, torch.rand((48, 3), generator=g) * 10 + torch.tensor(
            [-5, -5, 15.0]), torch.rand((48, 3), generator=g))
    params = {"Background": bp, "SMPLNodes": sp}
    statics = {"Background": {}, "SMPLNodes": {**ss, **sa}}
    masks = {"Background": bm, "SMPLNodes": sm}
    cfg = common.trainer_config_from(config.apply_dotlist(
        config.wrap(configs.OMNIRE_BILATERAL_TREE),
        ["trainer.use_voxel_deformer=true", "trainer.use_rigid=false",
         "trainer.use_deformable=false"]), 1, F, 1.0)

    j = lambda x: jnp.asarray(x.numpy())
    t, v = ss["template"], ss["vd_statics"]
    jstatics = {"Background": {}, "SMPLNodes": {
        "template": jsmpl_model.SMPLTemplate(
            j(t.j_canonical), j(t.a0_inv), j(t.verts_canonical),
            j(t.lbs_weights), jencoders.Static(t.parents)),
        "vd_statics": jvd.VoxelDeformerStatics(
            j(v.lbs_voxel_base), j(v.offset), j(v.scale), v.ratio),
        **{k: j(ss[k]) for k in ("instances_fv", "nn_ind", "on_mesh_x")},
        "point_ids": j(sa["point_ids"])}}
    jcfg = jtrainer.TrainerConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jm, jl = jax.jit(lambda p, s, m: jtrainer.collect_gaussians(
        jcfg, p, s, m, jnp.zeros(3), 0, 1, 0.5))(
        jax.tree.map(j, params), jstatics, jax.tree.map(j, masks))
    full = trainer.merge_statics(statics, {})
    tm, tl = trainer.collect_gaussians(cfg, params, full, masks,
                                       torch.zeros(3), 0, 1, 0.5)
    smpl = tl.numpy() == 2
    assert smpl.sum() == I * V and np.array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tm.means.numpy()[smpl],
                               np.asarray(jm.means)[smpl], atol=1e-5, rtol=0)
    # the deformer's weights moved the pedestrians off the mesh weights'
    tm0, _ = trainer.collect_gaussians(
        dataclasses.replace(cfg, use_voxel_deformer=False), params, full,
        masks, torch.zeros(3), 0, 1, 0.5)
    assert float((tm0.means - tm.means)[smpl].abs().max()) > 1e-3
