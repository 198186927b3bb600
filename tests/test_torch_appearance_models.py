"""The port's cycle loss, appearance-model set-up and the trainer's refined
training views against the JAX package (helpers in
tests/test_torch_appearance.py). Split from that file: the port's test files
hold at most four tests each, bar one parametrized test or tests that share
a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu_torch import configs, convert
from bilateral_driving_tpu_torch.models import bilateral
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.train import setup, trainer
from bilateral_driving_tpu_torch.utils import config

from test_torch_appearance import (H, N_IMAGES, ROOT, W, _drawn, _images,
                                   _parity, _shapes)
from test_torch_threads import one_torch_thread  # noqa: F401


def test_inverse_loss_matches_jax():
    # grids near the identity, so the composed affine inverts well
    rng = np.random.default_rng(19)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(
            np.float32), jbilateral.init_multiscale(None, N_IMAGES))
    rgb, gt = _images(20), _images(21)

    def jf(p, rgb, gt):
        mats = jbilateral.multiscale_affines(p, rgb, 1)
        return jbilateral.inverse_loss(mats, gt, rgb)

    def tf(p, rgb, gt):
        mats = bilateral.multiscale_affines(p, rgb, 1)
        return bilateral.inverse_loss(mats, gt, rgb)

    _parity(jf, tf, tree, rgb, gt)


@pytest.mark.parametrize("preset", ["omnire"])
def test_build_models_matches_jax_structure(preset):
    """build_models gives every leaf the JAX package's setup gives, of the
    same shape, with CamPosePerturb drawn where asked."""
    from bilateral_driving_tpu.train import setup as jsetup
    from bilateral_driving_tpu.tools import common as jcommon
    from bilateral_driving_tpu.utils import config as jconfig

    over = ["trainer.envlight_resolution=8", "trainer.use_camera_perturb=true"]
    cfg = common.trainer_config_from(config.apply_dotlist(
        config.wrap(configs.PRESETS[preset]), over), N_IMAGES, 2, 1.0)
    jtree = jconfig.apply_dotlist(jconfig.load_config(os.path.join(
        ROOT, "bilateral_driving_tpu", "configs", f"{preset}.yaml")), over)
    jcfg = jcommon.trainer_config_from(jtree, N_IMAGES, 2, 1.0)
    got = setup.build_models(cfg, "cpu")
    want = _drawn(_shapes(jsetup.build_models, jcfg), 0)
    want = dict(trainer.named_leaves(convert.tree_from_jax(want, "cpu")))
    got = dict(trainer.named_leaves(got))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert {trainer.label_for_path(k) for k in got} == {
        "sky", "affine", "camera_opt"}
    assert not got.get("CamPose/embeds", torch.zeros(1)).any()
    assert ("CamPose/embeds" in got) == (preset == "omnire")
    assert got["CamPosePerturb/embeds"].any()


def test_forward_refines_training_views_only():
    """trainer.forward on a tiny synthetic scene with both camera models:
    zero embeddings render the unrefined image bit for bit; moved ones
    change training views only, and the rendered loss reaches both pose
    tables through the view matrix and the SH camera origin."""
    from bilateral_driving_tpu_torch.data import synthetic

    g = torch.Generator().manual_seed(0)
    scene = synthetic.make_scene(
        g, num_bg=300, num_frames=12, num_cams=2, width=W, height=H,
        focal=20.0, num_rigid=1, rigid_pts=30, num_deformable=1,
        deformable_pts=30, device="cpu")
    tree = config.apply_dotlist(config.wrap(configs.PRESETS["omnire"]), [
        "trainer.use_smpl=false", "trainer.use_camera_perturb=true",
        "trainer.envlight_resolution=8", "render.isect_capacity=8192"])
    cfg = common.trainer_config_from(tree, 24, 12, 1.0)
    state, statics = synthetic.random_state(scene, cfg, g, 512, 10,
                                            device="cpu")
    full = trainer.merge_statics(statics, state.aux)
    views = {"train": synthetic.make_batch(scene, 2),
             "test": synthetic.make_batch(scene, 20)}
    poses = {k: state.params[k]["embeds"]
             for k in ("CamPose", "CamPosePerturb")}

    def render(batch, test=False):
        return trainer.forward(cfg, state.params, full, state.masks, batch,
                               10, in_test_set=test,
                               neighbor_idx=[18, 22] if test else None)

    with torch.no_grad():
        moved = {k: render(b, k == "test")["rgb"] for k, b in views.items()}
        for p in poses.values():
            p.zero_()
        still = {k: render(b, k == "test")["rgb"] for k, b in views.items()}
        off = trainer.forward(
            dataclasses.replace(cfg, use_camera_opt=False,
                                use_camera_perturb=False),
            state.params, full, state.masks, views["train"], 10)["rgb"]
    assert torch.equal(still["train"], off)
    assert not torch.equal(moved["train"], still["train"])
    assert torch.equal(moved["test"], still["test"])
    for p in poses.values():
        p.requires_grad_(True)
    loss = render(views["train"])["rgb"].square().mean()
    grads = torch.autograd.grad(loss, list(poses.values()))
    for name, gr in zip(poses, grads):
        assert gr[2].abs().sum() > 0, name
        assert not torch.cat([gr[:2], gr[3:]]).any(), name
