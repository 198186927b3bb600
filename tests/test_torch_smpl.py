"""The port's SMPL pedestrians and single bilateral grid against the JAX
package: the body model (the JAX package's synthetic body carried across
by bilateral_driving_tpu_torch/convert.py), the pickle reader, the mesh
initialisation, the node's Gaussians, its KNN and joint-smoothness
regularisers with their gradients, the pose loader on
tests/fixtures/proto_scene and the single grid (the omnire_bilateral
preset is held to its YAML in tests/test_torch_configs.py). Inputs come
from numpy with a seed; both sides run on the CPU.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from bilateral_driving_tpu.core import transforms as jtransforms
from bilateral_driving_tpu.data import scene as jscene
from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu.scene import smpl_model as jsmpl_model
from bilateral_driving_tpu.scene import smpl_node as jsmpl_node
from bilateral_driving_tpu.train import setup as jsetup
from bilateral_driving_tpu_torch import configs, convert
from bilateral_driving_tpu_torch.core import transforms
from bilateral_driving_tpu_torch.data import scene
from bilateral_driving_tpu_torch.models import bilateral
from bilateral_driving_tpu_torch.scene import smpl_model, smpl_node
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.train import trainer
from bilateral_driving_tpu_torch.utils import config

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCENE = os.path.join(ROOT, "tests", "fixtures", "proto_scene")
EPS = np.finfo(np.float32).eps
# the body model and the node's outputs: float32 chains of 4 x 4 products
# and einsums summed in other orders (measured up to 4e-6 on translations
# of a few metres)
ATOL, RTOL = 1e-5, 1e-5
# gradients, relative norm per leaf: the same sums in other orders
GRAD_RTOL = 1e-5
F, I, V = 6, 3, 40


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def body():
    jm = jsmpl_model.synthetic_model(jax.random.key(3), num_verts=V)
    betas = np.random.default_rng(0).normal(0, 1, (I, 10)).astype(np.float32)
    return jm, convert.smpl_model_from_jax(jm, "cpu"), betas


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


def _icosphere():
    """A closed mesh: the icosahedron subdivided once (42 vertices, 80
    faces) on the unit sphere."""
    t = (1.0 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.array(p, np.float64) / np.linalg.norm(p) for p in v]
    mid = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in mid:
            p = verts[a] + verts[b]
            verts.append(p / np.linalg.norm(p))
            mid[key] = len(verts) - 1
        return mid[key]

    out = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
    return np.array(verts, np.float32), np.array(out, np.int64)


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


@pytest.fixture(scope="module")
def node(body):
    """A JAX SMPLNodes class of I bodies over F frames (JAX setup), with
    random poses and anisotropic scales, instance 2 invalid in frames 1
    and 4; and its port through convert.py."""
    jm, _, betas = body
    rng = np.random.default_rng(4)
    root = rng.normal(size=(F, I, 1, 4)).astype(np.float32)
    bodyq = (np.asarray(jsmpl_model.da_pose_quats())[1:]
             + 0.2 * rng.normal(size=(F, I, 23, 4))).astype(np.float32)
    trans = (rng.normal(0, 1, (F, I, 3)) + [0.0, 0.0, 6.0]).astype(
        np.float32)
    fv = np.ones((F, I), bool)
    fv[[1, 4], 2] = False
    params, statics, aux, mask = jsetup.build_smpl(
        jax.random.key(5), jm, jnp.asarray(betas), jnp.asarray(root),
        jnp.asarray(bodyq), jnp.asarray(trans), jnp.asarray(fv))
    params = {k: np.asarray(v) for k, v in params.items()}
    params["log_scales"] = np.log(rng.uniform(0.01, 0.1, (I * V, 3))).astype(
        np.float32)
    params["sh_rest"] = rng.normal(0, 0.1, params["sh_rest"].shape).astype(
        np.float32)
    params["logit_opacities"] = rng.normal(0, 1, (I * V, 1)).astype(
        np.float32)
    params["means"] = params["means"] + rng.normal(
        0, 0.01, params["means"].shape).astype(np.float32)
    jstat = {**statics, **aux}
    tparams, tstat, taux, tmask = convert.scene_from_jax(
        params, statics, aux, mask, device="cpu")
    return dict(jparams={k: jnp.asarray(v) for k, v in params.items()},
                jstat=jstat, jmask=mask, tparams=tparams,
                tstat={**tstat, **taux}, tmask=tmask)


def _param_grads(fn, tparams):
    """The gradient of fn(params) by every float leaf."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    out = fn(leaves)
    grads = torch.autograd.grad(out, list(leaves.values()),
                                allow_unused=True)
    return out.detach(), {k: (torch.zeros_like(v) if g is None else g)
                          for (k, v), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize("test_view", [False, True], ids=["train", "test"])
@pytest.mark.parametrize("frame", [0, 1, F - 2, F - 1])
def test_node_gaussians_match_jax(node, frame, test_view):
    """Values and the gradients by every leaf, at the first and last
    frames (the test-view slerp gate) and at frames where instance 2 is
    invalid (1) or its neighbours are (F - 2 = 4 is invalid itself)."""
    cam = np.array([0.3, -0.2, 1.0], np.float32)
    step = 3000
    out_shape = (I * V,)
    rng = np.random.default_rng(10 + frame)
    w = {f: rng.normal(size=out_shape + s).astype(np.float32)
         for f, s in (("means", (3,)), ("scales", (3,)), ("quats", (4,)),
                      ("opacities", ()), ("rgbs", (3,)))}
    jg = jsmpl_node.gaussians(node["jparams"], node["jstat"], node["jmask"],
                              jnp.asarray(cam), step, frame, F, test_view)
    tg = smpl_node.gaussians(node["tparams"], node["tstat"], node["tmask"],
                             _t(cam), step, frame, F, test_view)
    for f in w:
        np.testing.assert_allclose(getattr(tg, f).numpy(),
                                   np.asarray(getattr(jg, f)), atol=ATOL,
                                   rtol=RTOL, err_msg=f)
    valid = np.asarray(node["jstat"]["instances_fv"])[frame]
    opac = tg.opacities.numpy().reshape(I, V)
    assert (opac[~valid] == 0).all() and (opac[valid] > 0).all()

    def loss_t(p):
        g = smpl_node.gaussians(p, node["tstat"], node["tmask"], _t(cam),
                                step, frame, F, test_view)
        return sum((getattr(g, f) * _t(w[f])).sum() for f in w)

    def loss_j(p):
        g = jsmpl_node.gaussians(p, node["jstat"], node["jmask"],
                                 jnp.asarray(cam), step, frame, F, test_view)
        return sum(jnp.sum(getattr(g, f) * jnp.asarray(w[f])) for f in w)

    _, tgrads = _param_grads(loss_t, node["tparams"])
    jgrads = jax.grad(loss_j)(node["jparams"])
    for k, g in tgrads.items():
        want = np.asarray(jgrads[k])
        if not np.any(want):
            assert not g.any(), k
            continue
        # the per-point rotation is the LBS blend (not orthonormal):
        # rotmat_to_quat takes the same candidate on both sides
        assert _rel(g.numpy(), want) < 1e-4, (k, _rel(g.numpy(), want))


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


def test_knn_neighbour_sets_match_jax(node):
    """The same float32 formula; ties (and near-ties within rounding) may
    order differently, so each point's neighbour set is compared."""
    means = node["jparams"]["means"]
    want = np.asarray(jsmpl_node.compute_knn(means, I, 5))
    got = smpl_node.compute_knn(_t(means), I, 5).numpy()
    assert got.shape == want.shape == (I, V, 5)
    same = [set(a) == set(b) for a, b in zip(got.reshape(-1, 5),
                                             want.reshape(-1, 5))]
    assert all(same), sum(not s for s in same)
    assert (got[..., 0] == np.arange(V)).all()        # itself first


REG = {"knn_reg": {"lambda_std_shs_dc": 0.5, "lambda_std_shs_rest": 0.2,
                   "lambda_std_o": 0.3, "lambda_std_s": 0.7,
                   "lambda_std_q": 0.1},
       "x_offset": {"w": 2.0}}


@pytest.mark.parametrize("frame", [0, 1, F - 2, F - 1])
def test_regularisers_match_jax(node, frame):
    """knn_reg_loss (population std over the neighbours: torch's
    correction=0 against jnp.std) and joint_smoothness_loss (gated by
    frame - 1 > 0, so frames 0 and 1 give 0 and zero gradients), values
    and gradients by every leaf."""
    nn_ind = jsmpl_node.compute_knn(node["jparams"]["means"], I, 5)
    tstat = {**node["tstat"], "nn_ind": _t(nn_ind)}

    def knn_t(p):
        return sum(smpl_node.knn_reg_loss(p, tstat, tstat["nn_ind"], frame,
                                          REG).values())

    def knn_j(p):
        return sum(jsmpl_node.knn_reg_loss(p, node["jstat"], nn_ind, frame,
                                           REG).values())

    tl = smpl_node.knn_reg_loss(node["tparams"], tstat, tstat["nn_ind"],
                                frame, REG)
    jl = jsmpl_node.knn_reg_loss(node["jparams"], node["jstat"], nn_ind,
                                 frame, REG)
    assert set(tl) == set(jl) == {"knn_reg_dc", "knn_reg_rest", "knn_reg_o",
                                  "knn_reg_s", "knn_reg_q", "x_offset"}
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5,
                                   err_msg=k)

    def smooth_t(p):
        return smpl_node.joint_smoothness_loss(p, node["tstat"], frame, F,
                                               0.01)

    def smooth_j(p):
        return jsmpl_node.joint_smoothness_loss(p, node["jstat"], frame, F,
                                                0.01)

    for ft, fj in ((knn_t, knn_j), (smooth_t, smooth_j)):
        val, tgrads = _param_grads(ft, node["tparams"])
        jval, jgrads = jax.value_and_grad(fj)(node["jparams"])
        np.testing.assert_allclose(float(val), float(jval), rtol=1e-5,
                                   atol=1e-9)
        for k, g in tgrads.items():
            want = np.asarray(jgrads[k])
            if not np.any(want):
                assert not g.any(), k
                continue
            assert _rel(g.numpy(), want) < GRAD_RTOL, (k, _rel(g.numpy(),
                                                              want))
    smooth = float(smooth_t(node["tparams"]))
    assert (smooth == 0.0) == (frame in (0, 1, F - 1))


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
