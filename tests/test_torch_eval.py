"""The port's evaluation loop against the JAX package's on a scene from
disk: tests/fixtures/proto_scene built by the JAX package's
tools/common.build_real_scene (its pedestrians in DeformableNodes, SMPL
off), carried across by convert.train_state_from_jax, rendered by both
render_images with per-image metrics, geometry metrics, colour-corrected
metrics and per-class decomposed renders.

Both run on the CPU; the JAX forward uses its XLA expansion path (its Pallas
expansion kernel is wrong on sparse tables, ROADMAP.md).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bilateral_driving_tpu.eval import render_loop as jrender_loop
from bilateral_driving_tpu.ops import pipeline as jpipeline
from bilateral_driving_tpu.tools import common as jcommon
from bilateral_driving_tpu.train import trainer as jtrainer
from bilateral_driving_tpu.utils import config as jconfig
from bilateral_driving_tpu_torch import convert
from bilateral_driving_tpu_torch.data import scene
from bilateral_driving_tpu_torch.eval import render_loop
from bilateral_driving_tpu_torch.train import density, trainer
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLAGSHIP_YAML = os.path.join(ROOT, "bilateral_driving_tpu", "configs",
                             "omnire_ms_bilateral.yaml")
SCENE = os.path.join(ROOT, "tests", "fixtures", "proto_scene")
PACK = os.path.join(ROOT, "tests", "fixtures", "proto_scene_pixels.npz")
OVERRIDES = [f"data.scene_dir={SCENE}", "data.cameras=[0,1]",
             "data.num_cams=2", "data.downscale=1",
             "trainer.envlight_resolution=16",
             "background_init.capacity=1024",
             "background_init.num_lidar_samples=400",
             "background_init.num_near_pts=100",
             "background_init.num_far_pts=100", "rigid_capacity=256",
             "render.isect_capacity=8192"]
STEP = 30000
IMAGES = (7, 20)      # a training view; frame 10, camera 0: a test view

_jax_rasterize = jpipeline.rasterize


def _jax_rasterize_xla(*args, **kw):
    cfg = args[-1] if len(args) == 10 else kw.pop("cfg")
    return _jax_rasterize(*args[:9], dataclasses.replace(
        cfg, pallas_expand=False), **kw)


def _port_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(trainer.TrainerConfig)}
    kw["density"] = density.DensityConfig(*jcfg.density)
    return trainer.TrainerConfig(**kw)


@pytest.fixture(scope="module")
def built():
    cfg = jconfig.load_config(FLAGSHIP_YAML, None, OVERRIDES)
    key = jax.random.key(0)
    tcfg, data, params, statics, aux, masks = jcommon.build_real_scene(
        key, cfg, interpret=True)
    # move the learned arrays off their initial values, so that each stage
    # of the forward (SH rest, opacities, grids, sky) is exercised
    rng = np.random.default_rng(0)

    def perturb(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if (x.dtype != np.float32 or "deform_net" in name
                or "instances" in name or "'means'" in name):
            return x
        sd = 0.05 if "sh_rest" in name else 0.1
        return (x + rng.normal(0, sd, x.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    jstate = jtrainer.init_state(key, tcfg, jax.tree.map(jnp.asarray, params),
                                 masks, aux).replace(step=jnp.asarray(STEP))
    pcfg = _port_config(tcfg)
    pstate = convert.train_state_from_jax(
        pcfg, params, aux, masks, jax.tree.map(np.asarray, jstate.stats),
        STEP, device="cpu")
    return dict(tcfg=tcfg, data=data, statics=statics, jstate=jstate,
                pcfg=pcfg, pstate=pstate,
                pstatics=convert.tree_from_jax(statics, "cpu"),
                pdata=scene.load_scene(SCENE, cameras=(0, 1),
                                       pixel_pack=PACK, device="cpu"))


def test_converted_state_holds_the_scene(built):
    s = built
    assert jtrainer.gaussian_classes(s["tcfg"]) == [
        "Background", "RigidNodes", "DeformableNodes"]
    p = s["pstate"].params["DeformableNodes"]
    jp = s["jstate"].params["DeformableNodes"]
    # the fixture's pedestrian rides in DeformableNodes with SMPL off
    assert p["instance_embeds"].shape == jp["instance_embeds"].shape
    w = np.asarray(jp["deform_net"]["trunk"][0]["w"])
    np.testing.assert_array_equal(
        p["deform_net"].trunk[0].weight.detach().numpy(), w.T)
    for name in s["pstate"].masks:
        np.testing.assert_array_equal(s["pstate"].masks[name].numpy(),
                                      np.asarray(s["jstate"].masks[name]))
    assert s["pstate"].step == STEP


def test_render_images_matches_jax(built, monkeypatch):
    s = built
    monkeypatch.setattr(jpipeline, "rasterize", _jax_rasterize_xla)
    nmap = s["data"].neighbor_train_indices(10)
    assert IMAGES[1] in nmap and IMAGES[0] not in nmap
    kw = dict(neighbor_map=nmap, compute_metrics=True, compute_geo=True,
              decompose_classes=True)
    want = jrender_loop.render_images(s["tcfg"], s["jstate"], s["statics"],
                                      s["data"], IMAGES, **kw)
    got = render_loop.render_images(
        s["pcfg"], s["pstate"], s["pstatics"], s["pdata"], IMAGES,
        neighbor_map=s["pdata"].neighbor_train_indices(10),
        compute_metrics=True, compute_geo=True, decompose_classes=True)
    for a, b in zip(got["rgbs"], want["rgbs"], strict=True):
        # PARITY.md's render tolerance
        np.testing.assert_allclose(a.numpy(), b, atol=3e-5, rtol=1e-4)
        assert b.std() > 0.05
    for name, renders in want["decomposed"].items():
        for a, b in zip(got["decomposed"][name], renders, strict=True):
            np.testing.assert_allclose(a.numpy(), b, atol=3e-5, rtol=1e-4,
                                       err_msg=name)
    _close_metrics(got["metrics"], want["metrics"])

    # colour-corrected metrics on the same renders
    want = jrender_loop.render_images(
        s["tcfg"], s["jstate"], s["statics"], s["data"], IMAGES[:1],
        compute_metrics=True, color_correct_eval=True)
    got = render_loop.render_images(
        s["pcfg"], s["pstate"], s["pstatics"], s["pdata"], IMAGES[:1],
        compute_metrics=True, color_correct_eval=True)
    # the render's 3e-5 plus the float32 least-squares fit, solved by
    # another factorisation on each side
    np.testing.assert_allclose(got["rgbs"][0].numpy(), want["rgbs"][0],
                               atol=5e-5)
    _close_metrics(got["metrics"], want["metrics"])
    agg = render_loop.aggregate_metrics(got["metrics"])
    assert agg.keys() == jrender_loop.aggregate_metrics(
        want["metrics"]).keys()


def _close_metrics(got, want):
    """Renders within 3e-5 move PSNR by well under 1e-3 dB at these error
    levels and SSIM by under 1e-4. Depth differs where alpha is small
    (the expected depth divides by it), so the geometry metrics hold to
    1e-3 relative."""
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for k in w:
            if "psnr" in k:
                np.testing.assert_allclose(g[k], w[k], atol=1e-3, err_msg=k)
            elif "ssim" in k:
                np.testing.assert_allclose(g[k], w[k], atol=1e-4, err_msg=k)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-3, err_msg=k)
