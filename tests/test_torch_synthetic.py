"""Synthetic mode (configs/synthetic.yaml) against the JAX package:
tools/common.build_synthetic_scene on the JAX package's generated scene
carried over by convert.synthetic_scene_from_jax (with SMPL in
tests/test_torch_synthetic_smpl.py), and one step of the CLI's synthetic
branch (targets rendered by the forward, every parameter perturbed, a
batch of synthetic.RenderedFrames) against the JAX CLI's.

The two frameworks' random draws differ (random quaternions and colours,
network initialisations, the perturbation): those are held by shape and
range, everything else to atol 1e-6, and the step starts from the JAX
package's perturbed parameters. The JAX forward and step run its default
path with `expand_gather_xla` in place of its Pallas expansion kernel, as
tests/test_torch_train.py explains: one compile of compute_grads serves
targets and step.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.data import synthetic as jsynthetic
from bilateral_driving_tpu.scene import smpl_model as jsmpl_model
from bilateral_driving_tpu.tools import common as jcommon
from bilateral_driving_tpu.train import trainer as jtrainer
from bilateral_driving_tpu.utils import config as jconfig
from bilateral_driving_tpu_torch import configs, convert
from bilateral_driving_tpu_torch.data import synthetic
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.train import trainer
from bilateral_driving_tpu_torch.utils import config

from test_torch_smpl_train import _torch_batch

from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_train import _jax_grads_by_path, _jax_reference_path, _rel

ROOT = os.path.join(os.path.dirname(__file__), "..")
SYNTHETIC_YAML = os.path.join(ROOT, "bilateral_driving_tpu", "configs",
                              "synthetic.yaml")
W, H, FRAMES, NUM_BG, BG_CAP, R = 64, 48, 2, 200, 256, 8
CAP = 2 ** 13
DATA = {"width": W, "height": H, "num_frames": FRAMES, "num_bg": NUM_BG,
        "bg_capacity": BG_CAP}
GRAD_RTOL = 2e-4          # per leaf, as tests/test_torch_train.py
ATOL = 1e-6               # built parameters, masks and statics
FRAME_ATOL = 3e-5         # rendered targets (PARITY.md §1)


def _configs(**trainer_keys):
    """The synthetic YAML as the JAX package loads it and the port's
    preset, both at this file's size."""
    jcfg = jconfig.load_config(SYNTHETIC_YAML)
    jcfg["data"].update(DATA)
    jcfg["trainer"].update(envlight_resolution=R, **trainer_keys)
    opts = [f"data.{k}={v}" for k, v in DATA.items()] + [
        f"trainer.envlight_resolution={R}"] + [
        f"trainer.{k}={str(v).lower()}" for k, v in trainer_keys.items()]
    pcfg = config.apply_dotlist(config.wrap(configs.PRESETS["synthetic"]),
                                opts)
    return jcfg, pcfg


def _leaves(params):
    return {k: v.detach() for k, v in trainer.named_leaves(params)}


# leaves drawn at random by the builders: uniform random quaternions, the
# SMPL body's random colours, instance codes and deformation networks
def _drawn(key):
    return (key.endswith("/quats") or key == "SMPLNodes/sh_dc"
            or "instance_embeds" in key or "deform_net" in key)


def _check_draw(key, got, want):
    """A drawn leaf: the same shape, and a draw of the same law."""
    assert got.shape == want.shape, key
    if key.endswith("/quats"):
        np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    elif key == "SMPLNodes/sh_dc":
        lo, hi = -0.5 / 0.28209479177387814, 0.5 / 0.28209479177387814
        assert lo - 1e-5 <= float(got.min()) and float(got.max()) <= hi + 1e-5
    elif got.dim() == 2 and "weight" in key:
        # U(+-1/sqrt(fan_in)) layers
        bound = 1.0 / math.sqrt(got.shape[1])
        assert float(got.abs().max()) <= bound + 1e-6, key
        assert float(got.abs().max()) > 0.5 * bound, key
    assert torch.isfinite(got).all(), key


def _check_knn_scales(key, got, want, means, mask):
    """KNN-initialised log scales: both frameworks form d^2 = |q|^2 - 2 q.r
    + |r|^2 in float32 and round it differently, so a mean distance d
    moves by up to 8 eps (|q|^2 + R^2) / (2 d), R the largest reference
    norm (tests/test_torch_cli.py::test_knn_scales_match_jax), and its log
    by that over d; dead slots are 0 in both."""
    live = mask.numpy().astype(bool)
    sq = np.sum(means.numpy()[live].astype(np.float64) ** 2, axis=-1)
    d = np.exp(want.numpy()[live, 0].astype(np.float64))
    tol = 8 * np.finfo(np.float32).eps * (sq + sq.max()) / (2 * d * d)
    diff = np.abs(got.numpy()[live] - want.numpy()[live]).max(-1)
    assert np.all(diff <= tol + ATOL), key
    assert not got.numpy()[~live].any() and not want.numpy()[~live].any()


def _same(a, b, path=""):
    """Statics, aux and masks: trees of tensors (the SMPL template a
    NamedTuple), equal to ATOL."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        for f in a._fields:
            _same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, torch.Tensor):
        # index arrays: int64 in the port, int32 in the JAX package
        assert a.shape == b.shape and a.is_floating_point() == \
            b.is_floating_point() and (a.dtype == torch.bool) == \
            (b.dtype == torch.bool), path
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                   rtol=0, atol=ATOL if a.is_floating_point()
                                   else 0, err_msg=path)
    else:
        assert tuple(a) == tuple(b) if isinstance(a, (list, tuple)) \
            else a == b, path


def check_build(background, smpl):
    """build_synthetic_scene on the carried-over scene and (with SMPL)
    body against the JAX package's build: the trainer config field by
    field, every parameter but the random draws and the KNN scales to
    ATOL, the draws by shape and law, the KNN scales to their float32
    rounding bound, masks, aux and statics to ATOL. With SMPL the
    DeformableNodes on the rigid instances are built too."""
    keys = {"background_model": background, "use_smpl": smpl,
            "use_deformable": smpl}
    jcfg, pcfg = _configs(**keys)
    jtcfg, jsc, jparams, jstatics, jaux, jmasks = \
        jcommon.build_synthetic_scene(jax.random.key(0), jcfg,
                                      interpret=True)
    body = convert.smpl_model_from_jax(jax.device_get(
        jsmpl_model.synthetic_model(jax.random.key(0), num_verts=64)),
        "cpu") if smpl else None
    tcfg, sc, params, statics, aux, masks = common.build_synthetic_scene(
        pcfg, 0, "cpu", scene=convert.synthetic_scene_from_jax(
            jax.device_get(jsc), "cpu"), smpl_body=body)
    for f in dataclasses.fields(trainer.TrainerConfig):
        assert getattr(tcfg, f.name) == getattr(jtcfg, f.name), f.name
    classes = {"Background", "RigidNodes"} | (
        {"SMPLNodes", "DeformableNodes"} if smpl else set())
    assert set(trainer.gaussian_classes(tcfg)) == classes
    want = _leaves(convert.tree_from_jax(jax.device_get(jparams), "cpu"))
    got = _leaves(params)
    assert set(got) == set(want)
    drawn = 0
    for k in want:
        name = k.split("/")[0]
        if _drawn(k):
            _check_draw(k, got[k], want[k])
            drawn += 1
        elif k.endswith("/log_scales") and name != "SMPLNodes":
            _check_knn_scales(k, got[k], want[k], got[f"{name}/means"],
                              masks[name])
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=ATOL, err_msg=k)
    assert drawn >= 2
    _same(masks, convert.tree_from_jax(jax.device_get(jmasks), "cpu"))
    _same(aux, convert.tree_from_jax(jax.device_get(jaux), "cpu"))
    _same(statics, convert.tree_from_jax(jax.device_get(jstatics), "cpu"))


@pytest.mark.parametrize("background", ["vanilla", "deformgs"])
def test_build_matches_jax(background):
    """check_build without pedestrians (tests/test_torch_synthetic_smpl.py
    has the builds with SMPL)."""
    check_build(background, False)


def _perturb(params, seed=1):
    """Every floating leaf moved by 0.05 N(0, 1), as the JAX CLI moves them
    (tools/train.py:120-126), drawn with numpy: the step is compared from
    the same perturbed parameters, whoever drew them."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + (0.05 * rng.normal(size=p.shape)).astype(p.dtype)
        if p.dtype == np.float32 else p, params)


@pytest.fixture(scope="module")
def step():
    """The synthetic preset's targets rendered by both forwards from one
    carried-over build, and the first CLI step of both trainers from the
    JAX package's perturbed parameters on frame 1. The JAX targets are the
    renders its compute_grads returns at step 0 (its forward, as the JAX
    CLI renders them), so one compile serves targets and step."""
    key = jax.random.key(0)
    jcfg, pcfg = _configs()
    jtcfg, jsc, jparams, jstatics, jaux, jmasks = \
        jcommon.build_synthetic_scene(key, jcfg, interpret=True)
    jtcfg = dataclasses.replace(jtcfg, isect_capacity=CAP)
    grads_fn = jax.jit(lambda st, b: jtrainer.compute_grads(
        jtcfg, jstatics, st, b))
    # strongly typed leaves (the build's Sky base is weakly typed), as the
    # perturbed ones are, so both calls share grads_fn's compile
    jparams = jax.tree.map(lambda x: jnp.array(x, dtype=x.dtype), jparams)
    jstate = jtrainer.init_state(key, jtcfg, jparams, jmasks, jaux)
    jbatches = []
    with _jax_reference_path():
        for f in range(FRAMES):
            b = jsynthetic.make_batch(jsc, f, jnp.zeros((H, W, 3)))
            b["pixels"] = jnp.clip(grads_fn(jstate, b)[2]["rgb"], 0, 1)
            jbatches.append(b)

    tcfg, sc, params, statics, aux, masks = common.build_synthetic_scene(
        pcfg, 0, "cpu", scene=convert.synthetic_scene_from_jax(
            jax.device_get(jsc), "cpu"))
    tcfg = dataclasses.replace(tcfg, isect_capacity=CAP)
    # the port renders its targets from the JAX package's parameters (the
    # random quaternions differ)
    tparams = convert.tree_from_jax(jax.device_get(jparams), "cpu")
    tfull = trainer.merge_statics(statics, aux)
    with torch.no_grad():
        frames = [torch.clamp(trainer.forward(
            tcfg, tparams, tfull, masks, synthetic.make_batch(sc, f),
            0)["rgb"], 0.0, 1.0) for f in range(FRAMES)]

    jparams = _perturb(jparams)
    jstate = jstate.replace(params=jparams)
    source = synthetic.RenderedFrames(
        sc, [torch.from_numpy(np.array(b["pixels"])) for b in jbatches])
    state = convert.train_state_from_jax(
        tcfg, jax.device_get(jparams), jax.device_get(jaux),
        jax.device_get(jmasks), jax.device_get(jstate.stats), 0,
        device="cpu", generator=torch.Generator().manual_seed(0))
    with _jax_reference_path():
        jg = grads_fn(jstate, jbatches[1])
    batch = source.get_batch(1)
    tg = trainer.compute_grads(tcfg, statics, state, batch)
    state, tm = trainer.apply_grads_and_refine(tcfg, statics, state, batch,
                                               *tg)
    return dict(jbatches=jbatches, frames=frames, source=source, jg=jg,
                tg=tg, tm=tm)


def test_targets_and_batches_match_jax(step):
    """The forward's targets within FRAME_ATOL of the JAX CLI's, in [0, 1]
    and not blank; RenderedFrames' batches equal make_batch's."""
    for f, (jb, got) in enumerate(zip(step["jbatches"], step["frames"])):
        want = np.asarray(jb["pixels"])
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FRAME_ATOL, err_msg=str(f))
        assert 0.0 <= want.min() and want.max() <= 1.0 and want.std() > 0.02
        tb = step["source"].get_batch(f)
        for k, v in _torch_batch(jb).items():
            if isinstance(v, torch.Tensor):
                np.testing.assert_allclose(tb[k].numpy(), v.numpy(),
                                           rtol=0, atol=1e-6, err_msg=k)
            else:
                assert tb[k] == pytest.approx(v, abs=1e-7), k
    with pytest.raises(ValueError):
        step["source"].get_batch(0, downscale=2)


def test_cli_step_matches_jax(step):
    """Losses within 1e-5 and every gradient leaf within GRAD_RTOL of the
    JAX step's; the step's parameters finite."""
    jg, tg = step["jg"], step["tg"]
    assert set(tg[1]) == set(jg[1])
    for k in jg[1]:
        np.testing.assert_allclose(float(tg[1][k]), float(jg[1][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = _jax_grads_by_path(jg[3])
    got = {k: v.numpy() for k, v in tg[3].items()}
    assert set(got) == set(want)
    assert sum(bool(np.any(v)) for v in got.values()) >= 8
    rel = {k: _rel(got[k], want[k]) for k in want}
    worst = max(rel, key=rel.get)
    assert rel[worst] < GRAD_RTOL, (worst, rel[worst])
    assert float(step["tm"]["nonfinite_params"]) == 0
