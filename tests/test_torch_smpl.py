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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.scene import smpl_model as jsmpl_model
from bilateral_driving_tpu.scene import smpl_node as jsmpl_node
from bilateral_driving_tpu.train import setup as jsetup
from bilateral_driving_tpu_torch import convert
from bilateral_driving_tpu_torch.scene import smpl_node
from test_torch_threads import one_torch_thread  # noqa: F401

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
