"""The port's offline rigid-instance editing (scene/rigid.py:
remove_instances, replace_instances) and out-of-box penalty against the
JAX package's: bit-equal on tests/test_variants.py's arrays, and a
RigidNodes scene of three cars drawn from a numpy seed, carried into the
port by convert.py, edited alike in both packages and rendered by each
package's RigidNodes forward (rigid.gaussians, then pipeline.rasterize;
the JAX package's with its XLA expansion in interpret mode, as
tests/test_torch_forward.py runs it) to the render tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import pipeline as jpipeline
from bilateral_driving_tpu.scene import rigid as jrigid
from bilateral_driving_tpu_torch import convert
from bilateral_driving_tpu_torch.ops import pipeline
from bilateral_driving_tpu_torch.scene import rigid
from test_torch_threads import one_torch_thread  # noqa: F401

W, H, FRAMES, CARS, PTS, DEAD = 64, 48, 3, 3, 48, 16
CAP = 2 ** 13
FRAME = 1
RENDER_ATOL = 3e-5            # rgb and alpha (PARITY.md §1)


def _variants_arrays(mask):
    """tests/test_variants.py's RigidEditing arrays (12 slots, three
    instances) as numpy, with the given alive mask."""
    cap = 12
    params = {
        "means": np.arange(cap * 3, dtype=np.float32).reshape(cap, 3),
        "quats": np.tile(np.array([1.0, 0, 0, 0], np.float32), (cap, 1)),
        "instances_quats": np.zeros((4, 3, 4), np.float32),
        "instances_trans": np.zeros((4, 3, 3), np.float32),
    }
    statics = {"point_ids": np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 0, 1, 2],
                                     np.int32),
               "instances_fv": np.ones((4, 3), bool),
               "instances_size": np.ones((3, 3), np.float32)}
    return params, statics, mask


def _both(params, statics, mask):
    """The same trees as JAX arrays and as the port's CPU tensors."""
    jtrees = [jax.tree.map(jnp.asarray, t) for t in (params, statics, mask)]
    return jtrees, [convert.tree_from_jax(t, "cpu")
                    for t in (params, statics, mask)]


def _equal(got, want, what):
    """A port tensor bit-equal to a JAX array, dtype included."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_editing_matches_jax_bit_for_bit():
    """Removals and replacements (one pair, two chained pairs, a donor
    into a dead-slot-free capacity that does not fit) on bool and float
    masks: the mask, point_ids and every parameter bit-equal, the inputs
    left as they were, and the same ValueError."""
    live = np.ones(12, bool)
    live[9:] = False
    cases = [("remove", live, [1]), ("remove", live.astype(np.float32),
                                     {0, 2}),
             ("replace", live, {1: 0}),
             ("replace", live.astype(np.float32), {1: 2, 0: 1}),
             ("replace", np.ones(12, bool), {1: 2})]
    for op, mask, ids in cases:
        (jp, js, jm), (tp, ts, tm) = _both(*_variants_arrays(mask))
        before = {k: v.clone() for k, v in tp.items()}
        if op == "remove":
            _equal(rigid.remove_instances(ts, tm, ids),
                   jrigid.remove_instances(js, jm, ids), f"{ids} mask")
            continue
        try:
            want = jrigid.replace_instances(jp, js, jm, ids)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                rigid.replace_instances(tp, ts, tm, ids)
            assert str(got.value) == str(e)
            continue
        p2, s2, m2 = rigid.replace_instances(tp, ts, tm, ids)
        _equal(m2, want[2], f"{ids} mask")
        _equal(s2["point_ids"], want[1]["point_ids"], f"{ids} point_ids")
        assert set(p2) == set(want[0])
        for k in p2:
            _equal(p2[k], want[0][k], f"{ids} {k}")
        for k, v in tp.items():
            assert torch.equal(v, before[k]), f"{k} written in place"


def _cars(seed: int = 0):
    """Three cars of PTS Gaussians each (slot order car 0, 1, 2, then DEAD
    dead slots) in front of a camera at the origin, with pose tracks over
    FRAMES frames: numpy trees of the JAX package's RigidNodes layout."""
    rng = np.random.default_rng(seed)
    cap = CARS * PTS + DEAD
    n = CARS * PTS
    sizes = np.tile(np.array([[1.8, 1.5, 4.0]], np.float32), (CARS, 1))
    pad = lambda x, fill=0.0: np.concatenate(
        [x, np.full((DEAD,) + x.shape[1:], fill, x.dtype)]).astype(np.float32)
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    yaw = rng.uniform(-0.6, 0.6, (FRAMES, CARS))
    trans = np.stack([np.broadcast_to([-2.6, 0.0, 2.6], (FRAMES, CARS)),
                      np.full((FRAMES, CARS), 0.4),
                      9.0 + 0.3 * np.arange(FRAMES)[:, None]
                      + np.zeros(CARS)], axis=-1)
    params = {
        "means": pad(rng.uniform(-0.45, 0.45, (n, 3)) * sizes[0]),
        "log_scales": pad(np.log(rng.uniform(0.15, 0.4, (n, 3)))),
        "quats": np.concatenate([quats, np.tile([[1.0, 0, 0, 0]], (DEAD, 1))]
                                ).astype(np.float32),
        "logit_opacities": pad(rng.uniform(0.0, 4.0, (n, 1)), -20.0),
        "sh_dc": pad(rng.normal(0.0, 0.8, (n, 1, 3))),
        "sh_rest": pad(rng.normal(0.0, 0.05, (n, 15, 3))),
        "instances_quats": np.stack([np.cos(yaw / 2), np.zeros_like(yaw),
                                     np.sin(yaw / 2), np.zeros_like(yaw)],
                                    -1).astype(np.float32),
        "instances_trans": trans.astype(np.float32),
    }
    statics = {"point_ids": np.concatenate(
        [np.repeat(np.arange(CARS), PTS), np.zeros(DEAD)]).astype(np.int32),
        "instances_fv": np.ones((FRAMES, CARS), bool),
        "instances_size": sizes}
    mask = (np.arange(cap) < n).astype(np.float32)
    return params, statics, mask


def _view():
    f = 0.9 * W
    K = np.array([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]],
                 np.float32)
    return np.eye(4, dtype=np.float32), K


def test_edited_scene_renders_as_jax():
    """Car 0 replaced by car 2's Gaussians (on car 0's pose track), car 1
    removed: the edited RigidNodes forward of each package at W x H, rgb
    and alpha within RENDER_ATOL, the same num_isects; removing car 1
    moved the image."""
    viewmat, K = _view()
    (jp, js, jm), (tp, ts, tm) = _both(*_cars())
    cam = np.zeros(3, np.float32)

    def jax_render(params, statics, mask):
        g = jrigid.gaussians(params, statics, mask, jnp.asarray(cam), 30000,
                             FRAME, FRAMES)
        return jpipeline.rasterize(
            g.means, g.quats, g.scales, g.opacities, g.rgbs,
            jnp.asarray(viewmat), jnp.asarray(K), W, H,
            jpipeline.RasterizeConfig(isect_capacity=CAP, interpret=True,
                                      pallas_expand=False))

    def edit_jax(p, s, m):
        p, s, m = jrigid.replace_instances(p, s, m, {0: 2})
        return p, s, jrigid.remove_instances(s, m, [1])

    def edit_port(p, s, m):
        p, s, m = rigid.replace_instances(p, s, m, {0: 2})
        return p, s, rigid.remove_instances(s, m, [1])

    render = jax.jit(jax_render)
    jo = render(*edit_jax(jp, js, jm))
    jo0 = render(jp, js, jm)
    g = rigid.gaussians(*edit_port(tp, ts, tm), torch.from_numpy(cam),
                        30000, FRAME, FRAMES)
    to = pipeline.rasterize(g.means, g.quats, g.scales, g.opacities, g.rgbs,
                            torch.from_numpy(viewmat), torch.from_numpy(K),
                            W, H, pipeline.RasterizeConfig(
                                isect_capacity=CAP))
    assert int(to["info"]["num_isects"]) == int(jo["info"]["num_isects"]) > 0
    assert not bool(to["info"]["overflow"])
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   atol=RENDER_ATOL, rtol=0, err_msg=k)
    moved = np.abs(np.asarray(jo["alpha"]) - np.asarray(jo0["alpha"]))
    assert (moved > 0.5).sum() >= 20


def test_out_of_box_penalty_matches_jax():
    """rigid.reg_loss on the cars with their points pushed partly out of
    their boxes and one car removed, to float32 rounding."""
    params, statics, mask = _cars(1)
    params["means"] = params["means"] * np.float32(1.4)
    mask[PTS:2 * PTS] = 0.0
    (jp, js, jm), (tp, ts, tm) = _both(params, statics, mask)
    want = float(jrigid.reg_loss(jp, js, jm, w_out_of_bound=0.5))
    got = float(rigid.reg_loss(tp, ts, tm, w_out_of_bound=0.5))
    assert want > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)
