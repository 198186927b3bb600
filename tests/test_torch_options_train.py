"""One training step with every option the eleventh slice ported turned on
at once, against the JAX package: omnire_bilateral with the MLP sky, the
voxel skinning deformer, rigid temporal smoothness and the Background's
flatten, sparse_reg and max_s_square_reg terms, on the JAX package's own
synthetic scene with an SMPL pedestrian carried across by convert.py.
Every loss term within 1e-5, every gradient leaf within GRAD_RTOL 2e-4
relative norm, and every new leaf with a gradient, moved off its zero or
drawn init first.

The JAX step runs its default path with `expand_gather_xla` in place of
its Pallas expansion kernel, compiled once, as tests/test_torch_train.py
explains.
"""
import dataclasses
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

from test_torch_smpl_train import _torch_batch
from test_torch_train import _jax_grads_by_path, _jax_reference_path, _rel
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
BILATERAL_YAML = os.path.join(ROOT, "bilateral_driving_tpu", "configs",
                              "omnire_bilateral.yaml")
W, H, FRAMES, CAP = 96, 64, 4, 2 ** 14
STEP = 3090           # sharp_shape_reg applies (every 10 steps)
GRAD_RTOL = 2e-4
OPTIONS = ["trainer.sky_model=mlp", "trainer.use_voxel_deformer=true",
           "losses.rigid_temporal=0.01",
           "background_reg.flatten={w: 0.01}",
           "background_reg.sparse_reg={w: 0.01}",
           "background_reg.max_s_square_reg={w: 0.01}"]
NEW_LEAVES = ("Sky/", "SMPLNodes/voxel_w_correction",
              "RigidNodes/instances_quats", "RigidNodes/instances_trans")
NEW_LOSSES = ("Background_flatten", "Background_sparse_reg",
              "Background_max_s_square", "RigidNodes_temporal")


@pytest.fixture(scope="module")
def step():
    cfg = jconfig.apply_dotlist(jconfig.load_config(BILATERAL_YAML), OPTIONS)
    cfg["data"] = jconfig.ConfigDict(
        {"width": W, "height": H, "num_frames": FRAMES, "num_bg": 300,
         "bg_capacity": 512})
    tcfg, jsc, params, statics, aux, masks = jcommon.build_synthetic_scene(
        jax.random.key(0), cfg, interpret=True)
    tcfg = dataclasses.replace(tcfg, isect_capacity=CAP)
    assert tcfg.sky_model == "mlp" and tcfg.use_voxel_deformer
    rng = np.random.default_rng(0)

    def perturb(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        smpl_track = "SMPLNodes" in name and "instances" in name
        if (x.dtype != np.float32 or "deform_net" in name
                or ("instances" in name and not smpl_track)
                or "'means'" in name):
            return x
        sd = (0.01 if "voxel" in name or smpl_track
              else 0.05 if "sh_rest" in name else 0.1)
        return (x + rng.normal(0, sd, x.shape)).astype(np.float32)

    # every learned array off its initial value (the voxel correction off
    # zero); the pedestrian's root track too: held still, its joints'
    # second differences are 0 up to rounding, where |x| gives either
    # sign's gradient; the pedestrian's Gaussians e^2 times the set-up's
    # 1 cm, as tests/test_torch_smpl_train.py explains
    params = jax.tree_util.tree_map_with_path(perturb, params)
    params = {**params, "SMPLNodes": {
        **params["SMPLNodes"],
        "log_scales": params["SMPLNodes"]["log_scales"] + np.float32(2.0)}}
    pcfg = common.trainer_config_from(
        config.apply_dotlist(config.wrap(configs.OMNIRE_BILATERAL_TREE),
                             OPTIONS),
        tcfg.num_images, tcfg.num_frames, tcfg.scene_scale)
    pcfg = dataclasses.replace(pcfg, isect_capacity=CAP)
    for f in dataclasses.fields(pcfg):
        if f.name != "envlight_resolution":
            assert getattr(pcfg, f.name) == getattr(tcfg, f.name), f.name
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtrainer.init_state(jax.random.key(1), tcfg, jparams, masks, aux)
    jstate = jstate.replace(step=jnp.asarray(STEP, jnp.int32))
    state = convert.train_state_from_jax(
        pcfg, params, aux, masks, jstate.stats, STEP, device="cpu",
        generator=torch.Generator().manual_seed(0))
    tstatics = convert.tree_from_jax(statics, "cpu")

    pixels = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    sky = (rng.random((H, W)) < 0.3).astype(np.float32)
    depth = np.where(rng.random((H, W)) < 0.1,
                     rng.uniform(3, 40, (H, W)), 0).astype(np.float32)
    jb = jsynthetic.make_batch(jsc, 2, jnp.asarray(pixels), jnp.asarray(sky),
                               jnp.asarray(depth))
    with _jax_reference_path():
        jg = jax.jit(lambda st, b: jtrainer.compute_grads(
            tcfg, statics, st, b))(jstate, jb)
    tg = trainer.compute_grads(pcfg, tstatics, state, _torch_batch(jb))
    return dict(jg=jg, tg=tg, params=params, state=state, pcfg=pcfg,
                statics=statics, aux=aux, masks=masks, batch=jb,
                stats=jstate.stats, tcfg=tcfg)


def test_losses_match_jax(step):
    jloss, tloss = step["jg"][1], step["tg"][1]
    assert set(tloss) == set(jloss)
    for k in NEW_LOSSES:
        assert float(tloss[k]) > 0, k
    for k in jloss:
        np.testing.assert_allclose(float(tloss[k]), float(jloss[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(step["tg"][0]), float(step["jg"][0]),
                               rtol=1e-5)


def test_every_leaf_gradient_matches_jax(step):
    want = _jax_grads_by_path(step["jg"][3])
    got = {k: v.numpy() for k, v in step["tg"][3].items()}
    assert set(got) == set(want)
    want["means2d"] = np.asarray(step["jg"][4])
    got["means2d"] = step["tg"][4].numpy()
    rels = {k: _rel(got[k], want[k]) for k in want}
    worst = max(rels, key=rels.get)
    assert rels[worst] < GRAD_RTOL, (worst, rels[worst])
    new = [k for k in want if k.startswith(NEW_LEAVES)]
    assert len(new) == 1 + 6 + 1 + 2, new      # Sky, voxel, rigid track
    for k in new:
        assert np.any(want[k]) and np.any(got[k]), k
    # the new leaves started off their zero or drawn init
    assert bool(step["state"].params["SMPLNodes"][
        "voxel_w_correction"].any())
    leaves = dict(trainer.named_leaves(step["state"].params))
    drawn = dict(trainer.named_leaves(convert.tree_from_jax(
        jax.tree.map(np.asarray, jcommon.setup.build_models(
            jax.random.key(0), dataclasses.replace(
                jtrainer.TrainerConfig(), sky_model="mlp", num_images=len(
                    step["params"]["Sky"]["embedding"]),
                affine_model="none"))), "cpu")))
    for k, v in drawn.items():
        assert not torch.equal(leaves[k].detach(), v), k
