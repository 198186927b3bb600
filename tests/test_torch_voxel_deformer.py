"""The port's voxel skinning deformer against the JAX package: the statics
at the default (16, 64, 64) resolution for two instances of the port's
256-vertex synthetic body (the same vertices and weights given to both),
within 1e-5 absolute; query_weights and the TV and magnitude regularisers
with their VJPs within 1e-5 relative norm. The JAX references run
jitted. Before smoothing, 14 of the 131,072 cells differ by up to 3.7e-5:
no neighbour set differs there (no k-boundary tie on this body); the
difference is the float32 rounding of the expanded distances to the
nearest vertices, which XLA fuses differently from any one PyTorch order,
amplified by the inverse-distance weights. The smoothing passes spread it
below 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.scene import voxel_deformer as jvd
from bilateral_driving_tpu_torch import convert
from bilateral_driving_tpu_torch.scene import smpl_model
from bilateral_driving_tpu_torch.scene import voxel_deformer as vd
from test_torch_appearance import _rel
from test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
VJP_RTOL = 1e-5
N_POINTS = 300


@pytest.fixture(scope="module")
def bodies():
    g = torch.Generator().manual_seed(0)
    model = smpl_model.synthetic_model(g, num_verts=256, device="cpu")
    betas = torch.randn((2, 10), generator=g)
    template = smpl_model.make_template(model, betas)
    verts = template.verts_canonical.numpy()
    weights = np.ascontiguousarray(template.lbs_weights.numpy())
    jst, _ = jax.jit(jvd.init_voxel_deformer)(jnp.asarray(verts),
                                              jnp.asarray(weights))
    st, params = vd.init_voxel_deformer(torch.from_numpy(verts),
                                        torch.from_numpy(weights))
    return dict(verts=verts, weights=weights, jst=jst, st=st, params=params)


def test_statics_match_jax(bodies):
    jst, st = bodies["jst"], bodies["st"]
    assert st.lbs_voxel_base.shape == (2, 24, 16, 64, 64)
    assert st.ratio == float(jst.ratio) == 4.0
    for k in ("lbs_voxel_base", "offset", "scale"):
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(jst, k)), atol=ATOL,
                                   rtol=0, err_msg=k)
    # every cell a convex blend of the joints' weights
    base = st.lbs_voxel_base
    assert bool((base >= 0).all())
    np.testing.assert_allclose(base.sum(1).numpy(), 1.0, atol=1e-5)
    assert not bool(bodies["params"]["voxel_w_correction"].any())
    conv = convert.tree_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    assert isinstance(conv, vd.VoxelDeformerStatics)
    assert conv.ratio == st.ratio and isinstance(conv.ratio, float)


def test_query_weights_and_vjp_match_jax(bodies):
    """Canonical points in and past the box (border clamp), a correction
    off zero; the VJP into the correction and the points."""
    rng = np.random.default_rng(1)
    jst = bodies["jst"]
    corr = rng.normal(0, 0.01, jst.lbs_voxel_base.shape).astype(np.float32)
    pts = (bodies["verts"][:, :N_POINTS // 2]
           + rng.normal(0, 0.05, (2, N_POINTS // 2, 3))).astype(np.float32)
    pts = np.concatenate([pts, rng.uniform(-2, 2, pts.shape).astype(
        np.float32)], axis=1)
    jf = jax.jit(lambda c, x: jvd.query_weights(
        jst, {"voxel_w_correction": c}, x))
    jout, vjp = jax.vjp(jf, jnp.asarray(corr), jnp.asarray(pts))
    st = convert.tree_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    tc = torch.from_numpy(corr).requires_grad_(True)
    tx = torch.from_numpy(pts).requires_grad_(True)
    tout = vd.query_weights(st, {"voxel_w_correction": tc}, tx)
    assert tout.shape == (2, N_POINTS, 24)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=0)
    ct = rng.normal(size=tout.shape).astype(np.float32)
    jg = vjp(jnp.asarray(ct))
    tg = torch.autograd.grad(tout, [tc, tx], torch.from_numpy(ct))
    for name, g, w in zip(("correction", "points"), tg, jg):
        assert np.any(np.asarray(w)), name
        assert _rel(g.numpy(), w) < VJP_RTOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("loss", ["tv_loss", "mag_loss"])
def test_regularisers_match_jax(loss):
    corr = np.random.default_rng(2).normal(
        0, 0.01, (2, 24, 4, 8, 8)).astype(np.float32)
    jval, jgrad = jax.jit(jax.value_and_grad(lambda c: getattr(jvd, loss)(
        {"voxel_w_correction": c})))(jnp.asarray(corr))
    tc = torch.from_numpy(corr).requires_grad_(True)
    tval = getattr(vd, loss)({"voxel_w_correction": tc})
    (tgrad,) = torch.autograd.grad(tval, tc)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    assert _rel(tgrad.numpy(), jgrad) < VJP_RTOL
