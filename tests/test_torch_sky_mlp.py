"""The port's MLP sky against the JAX package: sky_mlp_color on a train
view (the image's code) and a test view (the mean code), values within
1e-5 absolute and its VJP (jax.vjp against torch.autograd) within 1e-5
relative norm per parameter leaf and input, the initialiser's tree
carried across by convert.py (the head's skip at layer 1 kept out of the
tree), and the zero sky of sky_model "none" through the trainer's
forward."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.models import sky as jsky
from bilateral_driving_tpu_torch import configs, convert
from bilateral_driving_tpu_torch.data import synthetic
from bilateral_driving_tpu_torch.models import sky
from bilateral_driving_tpu_torch.train import setup, trainer
from test_torch_appearance import _drawn, _parity, _shapes
from test_torch_threads import one_torch_thread  # noqa: F401

NUM_IMAGES, IMG = 5, 3


@pytest.mark.parametrize("mean_embedding", [False, True])
def test_sky_mlp_color_matches_jax(mean_embedding):
    tree = _drawn(_shapes(jsky.init_sky_mlp, NUM_IMAGES), 0)
    dirs = np.random.default_rng(1).normal(size=(6, 7, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    out = _parity(
        lambda p, d: jsky.sky_mlp_color(p, d, IMG, mean_embedding),
        lambda p, d: sky.sky_mlp_color(p, d, IMG, mean_embedding),
        tree, dirs)
    assert out.shape == (6, 7, 3)
    assert bool(((out > 0) & (out < 1)).all())


def test_init_sky_mlp_matches_jax_tree():
    """The port's initialiser has the JAX package's shapes; the JAX tree
    (its head's static skips (1,)) converts to the port's nesting."""
    jtree = jsky.init_sky_mlp(jax.random.key(0), NUM_IMAGES)
    assert jtree["head"]["skips"].value == sky.SKY_SKIPS
    got = convert.tree_from_jax(jax.tree.map(np.asarray, jtree), "cpu")
    mine = sky.init_sky_mlp(NUM_IMAGES, torch.Generator().manual_seed(0),
                            device="cpu")
    want = dict(trainer.named_leaves(got))
    have = dict(trainer.named_leaves(mine))
    assert set(want) == set(have) == {
        "embedding", *(f"head/layers/{i}/{k}" for i in range(3)
                       for k in "wb")}
    for k in want:
        assert want[k].shape == have[k].shape, k
    assert trainer.label_for_path("Sky/head/layers/0/w") == "sky"
    assert trainer.label_for_path("Sky/embedding") == "sky"


def test_zero_sky_composites_nothing():
    """sky_model "none": no Sky parameters, a zero sky, the render of the
    Gaussians alone; "mlp": the MLP's colours over the same Gaussians."""
    g = torch.Generator().manual_seed(0)
    scene = synthetic.make_scene(g, num_bg=200, num_frames=2, width=32,
                                 height=24, device="cpu")
    cfg = dataclasses.replace(
        configs.flagship_config(scene.num_frames, scene.num_frames),
        use_deformable=False, affine_model="none", isect_capacity=2 ** 13)
    outs = {}
    for name in ("none", "mlp"):
        c = dataclasses.replace(cfg, sky_model=name)
        assert ("Sky" in setup.build_models(c, "cpu")) == (name == "mlp")
        state, statics = synthetic.random_state(
            scene, c, torch.Generator().manual_seed(1), 256, 0, "cpu")
        with torch.no_grad():
            outs[name] = trainer.forward(
                c, state.params, trainer.merge_statics(statics, state.aux),
                state.masks, synthetic.make_batch(scene, 1), 0)
    o = outs["none"]
    assert not bool(o["rgb_sky"].any())
    assert torch.equal(o["original_rgb"], o["rgb_gaussians"])
    assert torch.equal(o["rgb"], o["rgb_gaussians"])
    assert torch.equal(outs["mlp"]["rgb_gaussians"], o["rgb_gaussians"])
    assert bool((outs["mlp"]["rgb_sky"] > 0).all())
