"""The omnire_bilateral slice as a whole against the JAX package: a small
omnire_bilateral state with an SMPL pedestrian (made by the JAX package's
own synthetic set-up and carried across by convert.py), its forward on a
train and a test view, one plain training step and one refining step
(which resets every other class's opacities), the scene built from
tests/fixtures/proto_scene with SMPL on, and a few CPU steps of the CLI
with the omnire_bilateral preset.

The JAX steps run its default path with `expand_gather_xla` in place of
its Pallas expansion kernel, as tests/test_torch_train.py explains; the
forward runs its XLA expansion path (`pallas_expand=False`), as
tests/test_torch_forward.py explains.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.data import synthetic as jsynthetic
from bilateral_driving_tpu.tools import common as jcommon
from bilateral_driving_tpu.train import trainer as jtrainer
from bilateral_driving_tpu.utils import config as jconfig
from bilateral_driving_tpu_torch import configs, convert
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.train import trainer
from bilateral_driving_tpu_torch.utils import config

from test_torch_forward import _jax_rasterize_xla
from test_torch_train import _jax_grads_by_path, _jax_reference_path, _rel
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
BILATERAL_YAML = os.path.join(ROOT, "bilateral_driving_tpu", "configs",
                              "omnire_bilateral.yaml")
SCENE = os.path.join(ROOT, "tests", "fixtures", "proto_scene")
PACK = os.path.join(ROOT, "tests", "fixtures", "proto_scene_pixels.npz")
W, H, FRAMES, R = 96, 64, 4, 16
CAP = 2 ** 14
# the first step is ordinary; the second refines and resets opacities:
# 3100 % 3000 = 100 = refine_interval
STEP = 3099
# PARITY.md's render tolerance and tests/test_torch_train.py's per-leaf
# gradient tolerance
PARITY_ATOL = 3e-5
GRAD_RTOL = 2e-4


def _torch_batch(jb):
    out = {}
    for k, v in jb.items():
        v = np.array(v)
        out[k] = torch.from_numpy(v) if v.ndim else v.item()
    return out


@pytest.fixture(scope="module")
def run():
    cfg = jconfig.load_config(BILATERAL_YAML)
    cfg["data"] = jconfig.ConfigDict(
        {"width": W, "height": H, "num_frames": FRAMES, "num_bg": 300,
         "bg_capacity": 512})
    cfg["trainer"]["envlight_resolution"] = R
    tcfg, jsc, params, statics, aux, masks = jcommon.build_synthetic_scene(
        jax.random.key(0), cfg, interpret=True)
    tcfg = dataclasses.replace(tcfg, isect_capacity=CAP)
    assert tcfg.use_smpl and tcfg.affine_model == "bilateral"
    rng = np.random.default_rng(0)

    def perturb(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if (x.dtype != np.float32 or "deform_net" in name
                or "instances" in name or "'means'" in name):
            return x
        sd = 0.05 if "sh_rest" in name else 0.1
        return (x + rng.normal(0, sd, x.shape)).astype(np.float32)

    # every learned array off its initial value: SMPL joint quats, the
    # grids, SH rest, scales (anisotropic, so the quats get gradients)
    params = jax.tree_util.tree_map_with_path(perturb, params)
    # test_gradients_at_one_centimetre_against_float64 takes them as drawn
    params_1cm = params
    # the pedestrian's Gaussians e^2 = 7.4 times the JAX set-up's 1 cm:
    # at 1 cm they project to dots of radius 2 px at this size, whose
    # gradients (sums of opposite-signed per-pixel terms) the two
    # frameworks' float32 compositing gives up to 4.4e-4 apart in relative
    # norm (opacities), 1.2e-4 at 4 cm. Measured worst leaves at factors
    # e^2, e^2.28, e^2.3 and e^2.32: 1.1e-4 to 1.5e-4. At exactly 10x
    # (e^2.3026) the refining step's DeformableNodes leaves differ by
    # 4.2e-3: there one DeformableNodes Gaussian's alpha at one pixel is
    # 1.5e-8 below the 1/255 gate, and rounding puts it on either side
    # in the two frameworks (that pixel's rgb differs by 1.4e-4).
    params = {**params, "SMPLNodes": {
        **params["SMPLNodes"],
        "log_scales": params["SMPLNodes"]["log_scales"] + np.float32(2.0)}}
    # the pedestrian is invalid in frame 0
    fv = np.array(statics["SMPLNodes"]["instances_fv"])
    fv[0] = False
    statics["SMPLNodes"] = dict(statics["SMPLNodes"],
                                instances_fv=jnp.asarray(fv))
    pcfg = common.trainer_config_from(
        config.wrap(configs.OMNIRE_BILATERAL_TREE), tcfg.num_images,
        tcfg.num_frames, tcfg.scene_scale)
    pcfg = dataclasses.replace(pcfg, isect_capacity=CAP,
                               envlight_resolution=R)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtrainer.init_state(jax.random.key(1), tcfg, jparams, masks, aux)
    jstate = jstate.replace(step=jnp.asarray(STEP, jnp.int32))
    state = convert.train_state_from_jax(
        pcfg, params, aux, masks, jstate.stats, STEP, device="cpu",
        generator=torch.Generator().manual_seed(0))
    tstatics = convert.tree_from_jax(statics, "cpu")

    batches = []
    for frame in (1, 2):
        pixels = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        sky = (rng.random((H, W)) < 0.3).astype(np.float32)
        depth = np.where(rng.random((H, W)) < 0.1,
                         rng.uniform(3, 40, (H, W)), 0).astype(np.float32)
        batches.append(jsynthetic.make_batch(
            jsc, frame, jnp.asarray(pixels), jnp.asarray(sky),
            jnp.asarray(depth)))

    # the test view (frame 2, the pedestrian's pose slerped between frames
    # 1 and 3, the grids of images 1 and 3 averaged), before any step
    nbrs = [1, 3]
    fwd = jax.jit(functools.partial(jtrainer.forward, tcfg, in_test_set=True,
                                    rasterize_fn=_jax_rasterize_xla))
    jtest = fwd(jparams, jtrainer.merge_statics(statics, aux), masks,
                batches[1], jnp.asarray(STEP), neighbor_idx=jnp.asarray(nbrs))
    with torch.no_grad():
        ttest = trainer.forward(
            pcfg, state.params, trainer.merge_statics(tstatics, state.aux),
            state.masks, _torch_batch(batches[1]), STEP, in_test_set=True,
            neighbor_idx=nbrs)

    grads_fn = jax.jit(lambda st, b: jtrainer.compute_grads(
        tcfg, statics, st, b))
    first = dict(tcfg=tcfg, pcfg=pcfg, params=params_1cm, statics=statics,
                 aux=aux, masks=masks, batch=batches[0], grads_fn=grads_fn)
    apply_fn = jax.jit(functools.partial(jtrainer.apply_grads_and_refine,
                                         tcfg, statics))
    steps = []
    for jb in batches:
        with _jax_reference_path():
            jg = grads_fn(jstate, jb)
        tb = _torch_batch(jb)
        tg = trainer.compute_grads(pcfg, tstatics, state, tb)
        jstate, jm = apply_fn(jstate, jb, *jg)
        state, tm = trainer.apply_grads_and_refine(pcfg, tstatics, state, tb,
                                                   *tg)
        steps.append(dict(jg=jg, tg=tg, jm=jm, tm=tm, jstate=jstate,
                          masks={k: v.clone() for k, v in state.masks.items()},
                          params={k: {n: p.detach().clone()
                                      for n, p in d.items()
                                      if isinstance(p, torch.Tensor)}
                                  for k, d in state.params.items()
                                  if k != "Affine" and k != "Sky"}))
        jparams_now = dict(trainer.named_leaves(convert.tree_from_jax(
            jax.tree.map(np.asarray, jstate.params), "cpu")))
        with torch.no_grad():
            for k, p in trainer.named_leaves(state.params):
                p.copy_(jparams_now[k])
    return dict(steps=steps, state=state, jtest=jtest, ttest=ttest,
                first=first)


def test_forward_matches_jax(run):
    """The train view (the first step's forward) and the test view, at
    PARITY.md's atol on rgb and alpha; the pedestrian covers pixels."""
    s0 = run["steps"][0]
    for jo, to in ((s0["jg"][2], s0["tg"][2]), (run["jtest"], run["ttest"])):
        assert int(to["info"]["num_isects"]) == int(jo["info"]["num_isects"])
        for k in ("rgb", "opacity", "rgb_gaussians", "original_rgb"):
            np.testing.assert_allclose(to[k].detach().numpy(),
                                       np.asarray(jo[k]), atol=PARITY_ATOL,
                                       rtol=1e-4, err_msg=k)
        labels = to["labels"].numpy()
        radii = to["info"]["radii"].numpy()
        assert (radii[labels == 2] > 0).sum() > 30


def test_losses_match_jax(run):
    for i, s in enumerate(run["steps"]):
        jloss, tloss = s["jg"][1], s["tg"][1]
        assert set(tloss) == set(jloss)
        assert "SMPLNodes_joint_smooth" in tloss
        for k in jloss:
            np.testing.assert_allclose(float(tloss[k]), float(jloss[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i}: {k}")
        for k in s["jm"]:
            np.testing.assert_allclose(float(s["tm"][k]), float(s["jm"][k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i}: {k}")
    # frame 1: frame - 1 > 0 fails, so no smoothness; frame 2 has it
    assert float(run["steps"][0]["tg"][1]["SMPLNodes_joint_smooth"]) == 0.0
    assert float(run["steps"][1]["tg"][1]["SMPLNodes_joint_smooth"]) > 0.0


def test_gradients_match_jax_leaf_by_leaf(run):
    for s in run["steps"]:
        want = _jax_grads_by_path(s["jg"][3])
        got = {k: v.numpy() for k, v in s["tg"][3].items()}
        assert set(got) == set(want)
        smpl = [k for k in got if k.startswith("SMPLNodes/")]
        assert {"SMPLNodes/means", "SMPLNodes/instances_quats",
                "SMPLNodes/smpl_quats", "SMPLNodes/instances_trans",
                "SMPLNodes/quats"} <= set(smpl)
        for k in smpl + ["Affine/grids"]:
            assert np.any(got[k]), k
        rel = {k: _rel(got[k], want[k]) for k in want}
        worst = max(rel, key=rel.get)
        assert rel[worst] < GRAD_RTOL, (worst, rel[worst])
        assert _rel(s["tg"][4].numpy(), np.asarray(s["jg"][4])) < GRAD_RTOL


def test_refine_keeps_smpl_untouched(run):
    """The refining step resets the other classes' opacities and keeps the
    pedestrian's point count, opacities (moved by Adam alone, as in JAX)
    and Adam moments."""
    s = run["steps"][1]
    assert float(s["tm"]["refine_dropped"]) == float(s["jm"]["refine_dropped"])
    for name, m in s["masks"].items():
        np.testing.assert_array_equal(
            m.numpy().astype(bool),
            np.asarray(s["jstate"].masks[name]).astype(bool), name)
    smpl_pts = run["steps"][0]["masks"]["SMPLNodes"]
    assert int(s["masks"]["SMPLNodes"].sum()) == int(smpl_pts.sum()) > 0
    reset = float(np.log(np.float32(0.01 / 0.99)))
    bg = s["params"]["Background"]["logit_opacities"]
    assert float(bg[s["masks"]["Background"].bool()].max()) <= reset
    smpl_op = s["params"]["SMPLNodes"]["logit_opacities"]
    assert float(smpl_op.max()) > reset + 1.0
    np.testing.assert_allclose(
        smpl_op.numpy(),
        np.asarray(s["jstate"].params["SMPLNodes"]["logit_opacities"]),
        rtol=1e-5, atol=1e-6)
    p = run["state"].params["SMPLNodes"]["logit_opacities"]
    st = run["state"].opt.state[p]
    assert bool((st["exp_avg_sq"] > 0).all())


def test_parameter_groups_follow_the_jax_labels(run):
    """SMPL's pose tracks share their groups with RigidNodes' and
    DeformableNodes' (instances_quats, instances_trans), its means have
    their own (means_smpl), its joint quats theirs (smpl_quats)."""
    groups = {g["label"]: g["params"] for g in run["state"].opt.param_groups}
    smpl = run["state"].params["SMPLNodes"]
    for key, label, n in (("instances_quats", "instances_quats", 3),
                          ("instances_trans", "instances_trans", 3),
                          ("means", "means_smpl", 1),
                          ("smpl_quats", "smpl_quats", 1)):
        assert len(groups[label]) == n
        assert any(p is smpl[key] for p in groups[label]), key
    assert groups["affine"] == [run["state"].params["Affine"]["grids"]]


def _cast(tree, dtype):
    """The numpy tree with its float32 arrays cast to dtype."""
    return jax.tree.map(
        lambda x: np.asarray(x).astype(dtype)
        if np.asarray(x).dtype == np.float32 else np.asarray(x), tree)


def test_gradients_at_one_centimetre_against_float64(run):
    """The JAX set-up's pedestrian at its own 1 cm scale (the e^2 test
    above scales it): the first step's float32 gradients of both packages
    against one float64 evaluation of the same step, the port's plain path
    with every tensor cast to float64. Per leaf, the port's error is at
    most 1.5 times the JAX package's. The JAX step is the one compiled
    above, given new values of the same shapes."""
    f = run["first"]
    pcfg, statics, aux, masks = f["pcfg"], f["statics"], f["aux"], f["masks"]
    jstate = jtrainer.init_state(jax.random.key(1), f["tcfg"], jax.tree.map(
        jnp.asarray, f["params"]), masks, aux)
    jstate = jstate.replace(step=jnp.asarray(STEP, jnp.int32))
    with _jax_reference_path():
        jg = f["grads_fn"](jstate, f["batch"])
    want32 = _jax_grads_by_path(jg[3])

    def port_grads(dtype):
        state = convert.train_state_from_jax(
            pcfg, _cast(f["params"], dtype), aux, masks, jstate.stats, STEP,
            device="cpu", generator=torch.Generator().manual_seed(0))
        batch = _torch_batch(_cast(f["batch"], dtype))
        g = trainer.compute_grads(pcfg, convert.tree_from_jax(
            _cast(statics, dtype), "cpu"), state, batch)
        return g, {k: v.numpy() for k, v in g[3].items()}

    g64, want = port_grads(np.float64)
    assert g64[3]["SMPLNodes/means"].dtype == torch.float64
    g32, got32 = port_grads(np.float32)
    assert int(g32[2]["info"]["num_isects"]) == int(
        jg[2]["info"]["num_isects"]) == int(g64[2]["info"]["num_isects"])
    err = {k: (_rel(got32[k], want[k]), _rel(want32[k], want[k]))
           for k in want if np.any(want[k])}
    assert {"SMPLNodes/means", "SMPLNodes/logit_opacities",
            "SMPLNodes/smpl_quats"} <= set(err)
    # measured: the port within 3.6e-6 of float64 on every leaf (SMPLNodes
    # 1.3e-6 to 3.6e-6), the JAX package up to 4.45e-4 (SMPLNodes
    # logit_opacities; its other SMPLNodes leaves 6.3e-5 to 2.6e-4); the
    # closest leaves are Sky/base (8.3e-7 against 1.1e-6) and
    # DeformableNodes/instances_quats (9.0e-7 against 1.2e-6)
    worse = {k: e for k, e in err.items() if e[0] > 1.5 * e[1]}
    assert not worse, worse
    assert max(e[0] for e in err.values()) < GRAD_RTOL
