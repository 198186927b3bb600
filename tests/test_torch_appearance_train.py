"""The omnire slice as a whole against the JAX package: a small omnire
state (SMPL pedestrian, per-image affine codes, camera refinement) made by
the JAX package's own synthetic set-up and carried across by convert.py,
one training step leaf by leaf, and the CLI's save and resume with the
omnire preset on the CPU.

The JAX step runs its default path with `expand_gather_xla` in place of
its Pallas expansion kernel, as tests/test_torch_train.py explains.
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
from bilateral_driving_tpu_torch.tools import train as train_cli
from bilateral_driving_tpu_torch.train import trainer
from bilateral_driving_tpu_torch.utils import config

from test_torch_smpl_train import _torch_batch
from test_torch_train import _jax_grads_by_path, _jax_reference_path, _rel
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
OMNIRE_YAML = os.path.join(ROOT, "bilateral_driving_tpu", "configs",
                           "omnire.yaml")
SCENE = os.path.join(ROOT, "tests", "fixtures", "proto_scene")
PACK = os.path.join(ROOT, "tests", "fixtures", "proto_scene_pixels.npz")
# tests/test_torch_smpl_train.py's scene size, step and tolerance
W, H, FRAMES, R = 96, 64, 4, 16
CAP = 2 ** 14
STEP = 3099
GRAD_RTOL = 2e-4


@pytest.fixture(scope="module")
def run():
    cfg = jconfig.load_config(OMNIRE_YAML)
    cfg["data"] = jconfig.ConfigDict(
        {"width": W, "height": H, "num_frames": FRAMES, "num_bg": 300,
         "bg_capacity": 512})
    cfg["trainer"]["envlight_resolution"] = R
    tcfg, jsc, params, statics, aux, masks = jcommon.build_synthetic_scene(
        jax.random.key(0), cfg, interpret=True)
    tcfg = dataclasses.replace(tcfg, isect_capacity=CAP)
    assert tcfg.use_smpl and tcfg.use_camera_opt
    assert tcfg.affine_model == "affine"
    rng = np.random.default_rng(0)

    def perturb(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if (x.dtype != np.float32 or "deform_net" in name
                or "instances" in name or "'means'" in name):
            return x
        sd = {"CamPose": 0.01, "sh_rest": 0.05}.get(
            next((k for k in ("CamPose", "sh_rest") if k in name), ""), 0.1)
        return (x + rng.normal(0, sd, x.shape)).astype(np.float32)

    # every learned array off its initial value (the affine codes, their
    # decoder and the pose embeddings start at zero, where several leaves
    # get no gradient at all); the pedestrian's Gaussians at e^2 times the
    # JAX set-up's 1 cm, as tests/test_torch_smpl_train.py explains
    params = jax.tree_util.tree_map_with_path(perturb, params)
    params["SMPLNodes"]["log_scales"] = (params["SMPLNodes"]["log_scales"]
                                         + np.float32(2.0))
    pcfg = common.trainer_config_from(
        config.wrap(configs.OMNIRE_TREE), tcfg.num_images, tcfg.num_frames,
        tcfg.scene_scale)
    pcfg = dataclasses.replace(pcfg, isect_capacity=CAP,
                               envlight_resolution=R)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtrainer.init_state(jax.random.key(1), tcfg, jparams, masks, aux)
    jstate = jstate.replace(step=jnp.asarray(STEP, jnp.int32))
    state = convert.train_state_from_jax(
        pcfg, params, aux, masks, jstate.stats, STEP, device="cpu",
        generator=torch.Generator().manual_seed(0))
    tstatics = convert.tree_from_jax(statics, "cpu")
    pixels = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    sky = (rng.random((H, W)) < 0.3).astype(np.float32)
    depth = np.where(rng.random((H, W)) < 0.1, rng.uniform(3, 40, (H, W)),
                     0).astype(np.float32)
    jb = jsynthetic.make_batch(jsc, 1, jnp.asarray(pixels), jnp.asarray(sky),
                               jnp.asarray(depth))
    with _jax_reference_path():
        jg = jax.jit(lambda st, b: jtrainer.compute_grads(
            tcfg, statics, st, b))(jstate, jb)
    tg = trainer.compute_grads(pcfg, tstatics, state, _torch_batch(jb))
    return dict(jg=jg, tg=tg, state=state, pcfg=pcfg)


def test_step_gradients_match_jax_leaf_by_leaf(run):
    """Every leaf, the affine codes and the camera pose included, within
    GRAD_RTOL and non-zero; the losses within 1e-5."""
    jg, tg = run["jg"], run["tg"]
    assert set(tg[1]) == set(jg[1])
    for k in jg[1]:
        np.testing.assert_allclose(float(tg[1][k]), float(jg[1][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tg[2]["rgb"].detach().numpy(),
                               np.asarray(jg[2]["rgb"]), atol=3e-5,
                               rtol=1e-4)
    want = _jax_grads_by_path(jg[3])
    got = {k: v.numpy() for k, v in tg[3].items()}
    assert set(got) == set(want)
    assert {"Affine/embedding", "Affine/decoder/layers/0/w",
            "Affine/decoder/layers/1/b", "CamPose/embeds"} <= set(got)
    deform = ("DeformableNodes/deform_net", "Background/deform_net")
    for k in got:
        if not k.startswith(deform):
            assert np.any(got[k]), f"zero gradient of {k}"
    rel = {k: _rel(got[k], want[k]) for k in want}
    worst = max(rel, key=rel.get)
    assert rel[worst] < GRAD_RTOL, (worst, rel[worst])
    # only the stepped image's pose embedding moves
    pose = got["CamPose/embeds"]
    assert np.any(pose[1]) and not np.any(np.delete(pose, 1, axis=0))
    assert _rel(tg[4].numpy(), np.asarray(jg[4])) < GRAD_RTOL


def test_affine_and_pose_groups_follow_the_preset(run):
    """The affine codes take the omnire schedule (6e-4 -> 3e-5 after a
    1,000-step warm-up), the poses camera_opt's 1e-5."""
    groups = {g["label"]: g["params"] for g in run["state"].opt.param_groups}
    p = run["state"].params
    assert groups["camera_opt"] == [p["CamPose"]["embeds"]]
    assert len(groups["affine"]) == 5
    lr = {n: r for n, *r in run["pcfg"].lr}
    assert lr["affine"] == [6e-4, 3e-5, 1000]
    assert lr["camera_opt"] == [1e-5, None, 0]


def _cli(out, name, *extra):
    return train_cli.main([
        "--config", "omnire", "--device", "cpu", "--output_root", out,
        "--run_name", name, f"data.scene_dir={SCENE}",
        f"data.pixel_pack={PACK}", "data.cameras=[0,1]", "data.num_cams=2",
        "data.downscale=1", "data.test_image_stride=20",
        "trainer.envlight_resolution=16", "background_init.capacity=1024",
        "background_init.num_lidar_samples=400",
        "background_init.num_near_pts=100", "background_init.num_far_pts=100",
        "rigid_capacity=256", "render.isect_capacity=4096",
        "smpl.model_path=synthetic", "trainer.max_steps=5",
        "density.warmup_steps=1", "density.refine_interval=2",
        "res_schedule.downscale_times=0", "logging.log_every=1",
        "logging.metrics_flush_every=1", "logging.ckpt_every=2", *extra])


def test_cli_resumes_omnire_bit_equal(tmp_path):
    """tools.train --config omnire on the CPU for 5 steps, and again from
    its step-3 checkpoint (the refining step 4 among the two steps left):
    the two runs end with equal bits in every parameter, the affine
    decoder and the poses included, which moved."""
    out = str(tmp_path)
    summ = _cli(out, "full")
    assert summ["steps"] == 5 and summ["nonfinite_params_max"] == 0
    ckpts = os.path.join(out, "full", "checkpoints")
    resumed = _cli(out, "resumed", "--resume_from",
                   os.path.join(ckpts, "checkpoint_3.pt"))
    assert (resumed["start_step"], resumed["end_step"]) == (3, 5)
    a = torch.load(os.path.join(ckpts, "checkpoint_5.pt"),
                   weights_only=False)["params"]
    b = torch.load(os.path.join(out, "resumed", "checkpoints",
                                "checkpoint_5.pt"),
                   weights_only=False)["params"]
    init = torch.load(os.path.join(ckpts, "checkpoint_3.pt"),
                      weights_only=False)["params"]
    la, lb, l0 = (dict(trainer.named_leaves(t)) for t in (a, b, init))
    assert set(la) == set(lb)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    # (the embedding itself gets no gradient while the decoder is zero)
    for k in ("CamPose/embeds", "Affine/decoder/layers/1/b"):
        assert not torch.equal(la[k], l0[k]), k
