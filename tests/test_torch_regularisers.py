"""The Background regularisers (sharp_shape_reg, flatten, sparse_reg with
this step's radii, max_s_square_reg) and the rigid pose tracks' temporal
smoothness against the JAX package: values within 1e-5 relative and
gradients within 1e-5 relative norm, on numpy draws with dead slots, zero
radii and frames where an instance is not observed. The JAX references
run jitted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.scene import background as jbackground
from bilateral_driving_tpu.scene import rigid as jrigid
from bilateral_driving_tpu_torch.scene import background, rigid
from test_torch_appearance import _rel
from test_torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
N, F, I = 400, 7, 3
REGS = {"sharp_shape_reg": {"w": 1.0, "max_gauss_ratio": 3.0,
                            "step_interval": 10},
        "flatten": {"w": 0.01}, "sparse_reg": {"w": 0.02},
        "max_s_square_reg": {"w": 0.03}}


def _check(jf, tf, tree: dict, *statics):
    """Values and gradients of jf(tree, *statics) -> dict of losses
    against tf."""
    jv, jvjp = jax.vjp(jax.jit(jf), {k: jnp.asarray(v)
                                     for k, v in tree.items()}, *statics)
    tt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in tree.items()}
    tv = tf(tt, *(torch.from_numpy(np.asarray(s)) for s in statics))
    assert set(tv) == set(jv)
    for k in jv:
        np.testing.assert_allclose(float(tv[k].detach()), float(jv[k]),
                                   rtol=RTOL, err_msg=k)
        assert float(jv[k]) != 0, k
        jg = jvjp({n: jnp.asarray(1.0 if n == k else 0.0) for n in jv})[0]
        tg = torch.autograd.grad(tv[k], list(tt.values()),
                                 allow_unused=True, retain_graph=True)
        for (name, w), g in zip(jg.items(), tg):
            w = np.asarray(w)
            g = np.zeros_like(w) if g is None else g.numpy()
            if not w.any():
                assert not g.any(), (k, name)
                continue
            assert _rel(g, w) < RTOL, (k, name, _rel(g, w))


@pytest.mark.parametrize("with_radii", [True, False])
def test_background_regularisers_match_jax(with_radii):
    """At step 20 (sharp_shape_reg applies); sparse_reg needs the radii
    and is left out without them, in both packages."""
    rng = np.random.default_rng(0)
    tree = {"log_scales": rng.normal(-3, 1.0, (N, 3)).astype(np.float32),
            "logit_opacities": rng.normal(0, 2, (N, 1)).astype(np.float32)}
    mask = rng.random(N) < 0.8
    radii = np.where(rng.random(N) < 0.6, rng.integers(1, 9, N),
                     0).astype(np.int32)
    if with_radii:
        _check(lambda p, m, r: jbackground.reg_loss(p, m, r, 20, REGS),
               lambda p, m, r: background.reg_loss(p, m, 20, REGS,
                                                   cur_radii=r),
               tree, mask, radii)
    else:
        _check(lambda p, m: jbackground.reg_loss(p, m, None, 20, REGS),
               lambda p, m: background.reg_loss(p, m, 20, REGS),
               tree, mask)


def test_rigid_temporal_smoothness_matches_jax():
    """One weight for translation and rotation (the trainer's use), then
    two; frames where an instance is not seen in both neighbours drop
    out."""
    rng = np.random.default_rng(1)
    tree = {"instances_quats": rng.normal(size=(F, I, 4)).astype(np.float32),
            "instances_trans": rng.normal(size=(F, I, 3)).astype(np.float32)}
    fv = rng.random((F, I)) < 0.7
    for wt, wq in ((0.01, 0.01), (0.3, 2.0)):
        _check(lambda p, f: {"t": jrigid.temporal_smoothness_loss(
                   p, {"instances_fv": f}, wt, wq)},
               lambda p, f: {"t": rigid.temporal_smoothness_loss(
                   p, {"instances_fv": f}, wt, wq)},
               tree, fv)
