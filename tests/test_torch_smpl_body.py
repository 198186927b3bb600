"""The port's rotation conversions, SMPL body model, pickle reader and mesh
initialisation against the JAX package (helpers in
tests/test_torch_smpl.py). Split from that file: the port's test files hold
at most four tests each, bar one parametrized test or tests that share a
module fixture, so that pytest-xdist's count-ordered queue (--dist loadfile)
runs them after tests/test_parallel.py (README).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse
import torch

from bilateral_driving_tpu.core import transforms as jtransforms
from bilateral_driving_tpu.scene import smpl_model as jsmpl_model
from bilateral_driving_tpu_torch.core import transforms
from bilateral_driving_tpu_torch.scene import smpl_model

from test_torch_smpl import ATOL, EPS, I, RTOL, V, _icosphere, _t, body
from test_torch_threads import one_torch_thread  # noqa: F401


def test_axis_angle_conversions_match_jax():
    rng = np.random.default_rng(1)
    aa = rng.normal(0, 1, (50, 3)).astype(np.float32)
    aa[0] = 0.0                                  # finite at the origin
    for tf, jf in ((transforms.axis_angle_to_quat,
                    jtransforms.axis_angle_to_quat),
                   (transforms.axis_angle_to_rotmat,
                    jtransforms.axis_angle_to_rotmat)):
        x = _t(aa).requires_grad_(True)
        out = tf(x)
        w = rng.normal(size=out.shape).astype(np.float32)
        (g,) = torch.autograd.grad((out * _t(w)).sum(), x)
        jv, jg = jax.value_and_grad(
            lambda a: jnp.sum(jf(a) * jnp.asarray(w)))(jnp.asarray(aa))
        # sin, cos and the norm round differently in the two libraries:
        # a few float32 ulps of the unit-size entries
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jf(
            jnp.asarray(aa))), atol=8 * EPS, rtol=0)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(
        smpl_model.da_pose_quats(device="cpu").numpy(),
        np.asarray(jsmpl_model.da_pose_quats()), atol=EPS, rtol=0)


def test_body_model_matches_jax(body):
    """shape_model, batch_rigid_transform, make_template (A0 inverted by
    torch.linalg.inv and jnp.linalg.inv, to the same tolerance),
    skinning_transforms and lbs_apply."""
    jm, m, betas = body
    for a, b in zip(smpl_model.shape_model(m, _t(betas)),
                    jsmpl_model.shape_model(jm, jnp.asarray(betas))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    rng = np.random.default_rng(2)
    quats = rng.normal(size=(I, 24, 4)).astype(np.float32)
    joints = rng.normal(size=(I, 24, 3)).astype(np.float32)
    rot = transforms.quat_to_rotmat(_t(quats))
    for a, b in zip(
            smpl_model.batch_rigid_transform(rot, _t(joints), m.parents),
            jsmpl_model.batch_rigid_transform(
                jtransforms.quat_to_rotmat(jnp.asarray(quats)),
                jnp.asarray(joints), jm.parents)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    tpl = smpl_model.make_template(m, _t(betas))
    jtpl = jsmpl_model.make_template(jm, jnp.asarray(betas))
    assert tpl.parents == jtpl.parents.value == jm.parents
    for f in ("j_canonical", "a0_inv", "verts_canonical", "lbs_weights"):
        np.testing.assert_allclose(getattr(tpl, f).numpy(),
                                   np.asarray(getattr(jtpl, f)), atol=ATOL,
                                   rtol=RTOL, err_msg=f)
    A = smpl_model.skinning_transforms(tpl, _t(quats))
    jA = jsmpl_model.skinning_transforms(jtpl, jnp.asarray(quats))
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), atol=ATOL,
                               rtol=RTOL)
    pts = rng.normal(0, 0.5, (I, V, 3)).astype(np.float32)
    for a, b in zip(smpl_model.lbs_apply(tpl.lbs_weights, A, _t(pts)),
                    jsmpl_model.lbs_apply(jtpl.lbs_weights, jA,
                                          jnp.asarray(pts))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)


def test_load_model_reads_the_pickle(tmp_path):
    """The reader on a pickle written here in the SMPL file's layout (a
    sparse joint regressor, 300 shape directions of which 10 are kept);
    the licensed SMPL_NEUTRAL.pkl is not in the repository."""
    rng = np.random.default_rng(3)
    nv = 30
    jreg = np.where(rng.random((24, nv)) < 0.2, rng.random((24, nv)), 0.0)
    data = {"v_template": rng.normal(size=(nv, 3)),
            "shapedirs": rng.normal(size=(nv, 3, 300)),
            "J_regressor": scipy.sparse.csc_matrix(jreg),
            "weights": rng.random((nv, 24)),
            "kintree_table": np.stack([np.array(smpl_model.SMPL_PARENTS),
                                       np.arange(24)]),
            "f": rng.integers(0, nv, (50, 3)).astype(np.uint32)}
    path = str(tmp_path / "body.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)
    got = smpl_model.load_model(path, device="cpu")
    want = jsmpl_model.load_model(path)
    for f in ("v_template", "shapedirs", "j_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.shapedirs.shape == (nv, 3, 10)
    assert got.parents == want.parents == smpl_model.SMPL_PARENTS
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.faces.dtype == np.int64


def test_mesh_init_matches_jax():
    """The port takes the RandomState seed that the JAX package draws from
    its key; quaternions agree to 2 ulp (XLA's CPU rsqrt is not correctly
    rounded), scales exactly (both numpy)."""
    verts, faces = _icosphere()
    assert verts.shape == (42, 3) and faces.shape == (80, 3)
    stacked = np.stack([0.3 * verts, 0.5 * verts + 1.0])
    key = jax.random.key(7)
    jq, js = jsmpl_model.mesh_init_qso(jnp.asarray(stacked), faces, key)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    q, s = smpl_model.mesh_init_qso(stacked, faces, seed)
    np.testing.assert_allclose(q, np.asarray(jq), atol=2 * EPS, rtol=0)
    np.testing.assert_array_equal(s, np.asarray(js))
    # the first body's frames have their z axes along the sphere's
    # outward normals
    z = transforms.quat_to_rotmat(_t(q[:42])).numpy()[..., 2]
    np.testing.assert_allclose(np.sum(z * verts, -1), 1.0, atol=1e-2)
