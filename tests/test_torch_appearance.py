"""The port's appearance models and camera refinement against the JAX
package: the MLP and sinusoidal encoders, the affine codes, the 6D
rotation and the camera-pose deltas, the neural and multi-scale neural
bilateral grids, the CP-4D grid and the bilateral cycle loss. Parameters
are the JAX package's initialisers moved off their initial values with a
seeded numpy draw and carried across by bilateral_driving_tpu_torch/
convert.py; images are 3 of 24 x 16 px. Each function's values are held
within 1e-5 absolute, and its VJP (jax.vjp against torch.autograd, for a
seeded cotangent) within 1e-5 relative norm per parameter leaf and input.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.core import transforms as jtransforms
from bilateral_driving_tpu.models import affine as jaffine
from bilateral_driving_tpu.models import encoders as jencoders
from bilateral_driving_tpu_torch import convert
from bilateral_driving_tpu_torch.models import affine
from bilateral_driving_tpu_torch.models import encoders
from bilateral_driving_tpu_torch.train import trainer
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
N_IMAGES, H, W = 3, 16, 24
ATOL = 1e-5
VJP_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _shapes(fn, *args, **kw):
    """The tree a JAX initialiser returns, its arrays as shapes (nothing is
    compiled or run)."""
    return jax.eval_shape(lambda k: fn(k, *args, **kw), jax.random.key(0))


def _drawn(tree, seed: int, sd: float = 0.3):
    """Numpy float32 normal draws in the shapes of a tree of shapes (its
    static leaves kept): parameters away from any initial value."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: rng.normal(0, sd, x.shape).astype(np.float32), tree)


def _parity(jf, tf, tree, *inputs, seed=0, vjp_rtol=VJP_RTOL):
    """jf(tree, *inputs) of the JAX package against tf of the port, the
    tree (numpy, JAX nesting) carried across by convert.tree_from_jax.
    Returns the port's output."""
    jtree = jax.tree.map(jnp.asarray, tree)
    jin = [jnp.asarray(x) for x in inputs]
    jout, vjp = jax.vjp(jax.jit(jf), jtree, *jin)
    ttree = convert.tree_from_jax(tree, "cpu")
    leaves = dict(trainer.named_leaves(ttree))
    for p in leaves.values():
        p.requires_grad_(True)
    tin = [_t(x).requires_grad_(True) for x in inputs]
    tout = tf(ttree, *tin)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=0)
    ct = np.random.default_rng(seed).normal(
        size=np.shape(jout)).astype(np.float32)
    jg = vjp(jnp.asarray(ct))
    tg = torch.autograd.grad(tout, [*leaves.values(), *tin], _t(ct),
                             allow_unused=True)
    want = dict(trainer.named_leaves(convert.tree_from_jax(
        jax.tree.map(np.asarray, jg[0]), "cpu")))
    assert set(want) == set(leaves)
    got = dict(zip([*leaves, *range(len(tin))], tg))
    want.update({i: g for i, g in enumerate(jg[1:])})
    for k, g in got.items():
        w = np.asarray(want[k])
        g = np.zeros_like(w) if g is None else g.numpy()
        assert np.any(w), f"zero JAX gradient of {k}"
        assert _rel(g, w) < vjp_rtol, (k, _rel(g, w))
    return tout


def _images(seed: int):
    return np.random.default_rng(seed).uniform(
        0, 1, (H, W, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# encoders
# --------------------------------------------------------------------------


@pytest.mark.parametrize("skips", [(), (2,)])
def test_mlp_apply_matches_jax(skips):
    shapes = _shapes(jencoders.mlp_init, 5, 7, 4, 16, skips=skips)
    x = np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32)
    # the port keeps skips out of the tree: the caller passes them
    tree = {"layers": _drawn(shapes["layers"], 0)}
    _parity(lambda p, x: jencoders.mlp_apply(
        {**p, "skips": jencoders.Static(skips)}, x),
        lambda p, x: encoders.mlp_apply(p, x, skips), tree, x)


def test_mlp_init_matches_jax_shapes_and_zeros():
    """The JAX package's layer shapes; Kaiming-uniform within 1/sqrt(in);
    zero_init_last zeroes the last layer, zero_init_all every layer."""
    g = torch.Generator().manual_seed(0)
    for kw in ({}, {"skips": (1, 2)}, {"zero_init_last": True},
               {"zero_init_all": True}):
        jp = _shapes(jencoders.mlp_init, 5, 12, 3, 8, **kw)
        tp = encoders.mlp_init(g, 5, 12, 3, 8, device="cpu", **kw)
        assert set(tp) == {"layers"}
        for i, (jl, tl) in enumerate(zip(jp["layers"], tp["layers"],
                                         strict=True)):
            zero = kw.get("zero_init_all") or (kw.get("zero_init_last")
                                               and i == 2)
            for k in ("w", "b"):
                assert tuple(tl[k].shape) == jl[k].shape, (kw, k)
                bound = 1.0 / np.sqrt(jl["w"].shape[0])
                assert float(tl[k].abs().max()) <= bound
                assert bool(tl[k].any()) != bool(zero), (kw, i, k)


# --------------------------------------------------------------------------
# affine codes
# --------------------------------------------------------------------------


def test_affine_init_is_the_identity():
    p = affine.init_affine(torch.Generator().manual_seed(0), N_IMAGES,
                           device="cpu")
    jp = _shapes(jaffine.init_affine, N_IMAGES)
    assert p["embedding"].shape == jp["embedding"].shape
    assert not p["embedding"].any()
    assert all(not layer[k].any() for layer in p["decoder"]["layers"]
               for k in ("w", "b"))
    assert torch.equal(affine.affine_mats(p, 0), torch.eye(3, 4))


# --------------------------------------------------------------------------
# camera refinement
# --------------------------------------------------------------------------


def _c2w(seed: int):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.asarray(jtransforms.quat_to_rotmat(jnp.asarray(q)))
    c2w[:3, 3] = rng.uniform(-20, 20, 3)
    return c2w


# --------------------------------------------------------------------------
# neural and CP-4D bilateral grids, the cycle loss
# --------------------------------------------------------------------------


NEIGHBOURS = [None, [0, 2]]


# --------------------------------------------------------------------------
# the models as the trainer builds them
# --------------------------------------------------------------------------
