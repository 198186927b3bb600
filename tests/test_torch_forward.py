"""The port's flagship forward against the JAX package's, through
bilateral_driving_tpu_torch/convert.py: train, test and novel views of a
small omnire_ms_bilateral scene built by the JAX package's own builders,
plus the sky, bilateral and render-loop pieces on their own."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.data import synthetic as jsynthetic
from bilateral_driving_tpu.ops import pipeline as jpipeline
from bilateral_driving_tpu.tools import common
from bilateral_driving_tpu.train import trainer as jtrainer
from bilateral_driving_tpu.utils import config as config_lib
from bilateral_driving_tpu_torch import configs, convert
from bilateral_driving_tpu_torch.train import trainer
from test_torch_threads import one_torch_thread  # noqa: F401

FLAGSHIP_YAML = os.path.join(os.path.dirname(__file__), "..",
                             "bilateral_driving_tpu", "configs",
                             "omnire_ms_bilateral.yaml")
W, H, FRAMES, R = 96, 64, 4, 16
STEP = 30000
CAP = 2 ** 14


def _jax_rasterize_xla(*args, **kw):
    """The JAX pipeline with its XLA expansion path. Its Pallas expansion
    kernel (the default) assumes every 128-entry chunk spans at most 256
    table rows; the capacity padding between scene classes breaks that
    without tripping its window check, so it returns wrong Gaussian ids
    here (ROADMAP.md, faults found). The XLA path is the one its kernel is
    documented to equal."""
    return jpipeline.rasterize(
        *args[:-1], dataclasses.replace(args[-1], pallas_expand=False), **kw)


@pytest.fixture(scope="module")
def scene():
    cfg = config_lib.load_config(FLAGSHIP_YAML)
    cfg["data"] = config_lib.ConfigDict(
        {"width": W, "height": H, "num_frames": FRAMES, "num_bg": 300,
         "bg_capacity": 512})
    cfg["trainer"]["envlight_resolution"] = R
    tcfg, jscene, params, statics, aux, masks = common.build_synthetic_scene(
        jax.random.key(0), cfg, interpret=True)
    tcfg = dataclasses.replace(tcfg, isect_capacity=CAP)
    # move every learned array off its initial value (SH rest, opacities,
    # grids, sky...) so each stage of the forward is exercised
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
    tparams, tstatics, taux, tmasks = convert.scene_from_jax(
        params, statics, aux, masks, device="cpu")
    pcfg = configs.flagship_config(tcfg.num_images, tcfg.num_frames,
                                   isect_capacity=CAP, envlight_resolution=R)
    return dict(
        tcfg=tcfg, jscene=jscene, params=jax.tree.map(jnp.asarray, params),
        statics=jtrainer.merge_statics(statics, aux), masks=masks, pcfg=pcfg,
        tparams=tparams, tstatics=trainer.merge_statics(tstatics, taux),
        tmasks=tmasks)


def _torch_batch(jb):
    out = {}
    for k, v in jb.items():
        v = np.array(v)
        out[k] = torch.from_numpy(v) if v.ndim else v.item()
    return out


@pytest.mark.parametrize("view", ["train", "test", "novel", "dynamic"])
def test_flagship_forward_matches_jax(scene, view):
    """"dynamic": a training view with the dynamic-region weight on, which
    adds the second, dynamic-classes-only rasterize."""
    s = scene
    frame = {"train": 1, "test": 2, "novel": 3, "dynamic": 2}[view]
    test = view in ("test", "novel")
    tcfg, pcfg = s["tcfg"], s["pcfg"]
    if view == "dynamic":
        tcfg = dataclasses.replace(tcfg, w_dynamic_region=1.0)
        pcfg = dataclasses.replace(pcfg, w_dynamic_region=1.0)
    jb = jsynthetic.make_batch(s["jscene"], frame, jnp.zeros((H, W, 3)))
    if view == "novel":
        c2w = np.array(jb["camera_to_world"])
        c2w[:3, 3] += [0.7, -0.1, 0.3]
        jb = dict(jb, camera_to_world=jnp.asarray(c2w))
    nbrs = [1, 3] if view == "test" else None
    fwd = jax.jit(functools.partial(
        jtrainer.forward, tcfg, in_test_set=test,
        novel_view=view == "novel", rasterize_fn=_jax_rasterize_xla))
    jo = fwd(s["params"], s["statics"], s["masks"], jb, jnp.asarray(STEP),
             neighbor_idx=None if nbrs is None else jnp.asarray(nbrs))
    to = trainer.forward(pcfg, s["tparams"], s["tstatics"], s["tmasks"],
                         _torch_batch(jb), STEP, in_test_set=test,
                         novel_view=view == "novel", neighbor_idx=nbrs)

    assert int(to["info"]["num_isects"]) == int(jo["info"]["num_isects"]) > 0
    assert not bool(to["info"]["overflow"])
    opacity = np.asarray(jo["opacity"])
    assert opacity.mean() > 0.3
    # PARITY.md render tolerance; depth as in tests/test_goldens.py
    for k in ("rgb_gaussians", "opacity", "rgb_sky", "original_rgb", "rgb"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   atol=3e-5, rtol=1e-4, err_msg=k)
    hit = opacity[..., 0] > 0.2
    np.testing.assert_allclose(to["depth"].numpy()[..., 0][hit],
                               np.asarray(jo["depth"])[..., 0][hit],
                               atol=1e-3, rtol=1e-4)
    assert ("Dynamic_opacity" in to) == ("Dynamic_opacity" in jo) \
        == (view == "dynamic")
    if view == "dynamic":
        # the JAX forward renders this pass with pipeline.rasterize itself
        # (not rasterize_fn), so its Pallas expansion fault shows there;
        # the reference is the same pass through the XLA expansion, as
        # one jitted program
        def dynamic_alpha():
            merged, labels = jtrainer.collect_gaussians(
                tcfg, s["params"], s["statics"], s["masks"],
                jb["camera_to_world"][:3, 3], jnp.asarray(STEP),
                jb["frame_idx"], jb["normed_time"])
            dyn_op = jnp.where(labels != 0, merged.opacities, 0.0)
            c2w = jb["camera_to_world"]
            view_m = jnp.eye(4).at[:3, :3].set(c2w[:3, :3].T).at[:3, 3].set(
                -c2w[:3, :3].T @ c2w[:3, 3])
            return _jax_rasterize_xla(
                merged.means, merged.quats, merged.scales, dyn_op,
                merged.rgbs, view_m, jb["intrinsics"], W, H,
                jpipeline.RasterizeConfig(
                    near_plane=tcfg.near_plane, far_plane=tcfg.far_plane,
                    isect_capacity=CAP, interpret=True))["alpha"]

        want = np.asarray(jax.jit(dynamic_alpha)())
        assert 0.0 < want.mean() < opacity.mean()
        np.testing.assert_allclose(to["Dynamic_opacity"].numpy(), want,
                                   atol=3e-5, rtol=1e-4)
