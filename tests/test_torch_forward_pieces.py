"""The port's EnvLight and bilateral pieces, render loop and unported branches
against the JAX package (helpers in tests/test_torch_forward.py). Split from
that file: the port's test files hold at most four tests each, bar one
parametrized test or tests that share a module fixture, so that pytest-
xdist's count-ordered queue (--dist loadfile) runs them after
tests/test_parallel.py (README).
"""
import jax
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu.models import sky as jsky
from bilateral_driving_tpu_torch import configs
from bilateral_driving_tpu_torch.data import synthetic
from bilateral_driving_tpu_torch.eval import render_loop
from bilateral_driving_tpu_torch.models import bilateral, sky
from bilateral_driving_tpu_torch.ops import expand_cuda, rasterize_cuda
from bilateral_driving_tpu_torch.train import setup, trainer

from test_torch_forward import CAP, H, R, STEP, W
from test_torch_threads import one_torch_thread  # noqa: F401


def test_envlight_and_bilateral_pieces_match_jax():
    """Each JAX piece runs as one jitted program."""
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, (6, 8, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(40, 30, 3)).astype(np.float32)
    dirs[0, 0] = 0.0                                     # safe at the origin
    np.testing.assert_allclose(
        sky.envlight_color({"base": torch.from_numpy(base)},
                           torch.from_numpy(dirs)).numpy(),
        np.asarray(jax.jit(lambda b, d: jsky.envlight_color(
            {"base": b}, d, interpret=True))(base, dirs)),
        atol=1e-6)

    img = rng.uniform(0, 1, (37, 53, 12)).astype(np.float32)
    resize = jax.jit(jbilateral.resize_bilinear, static_argnums=(1, 2))
    for h, w in ((9, 13), (18, 26), (37, 53), (74, 106)):
        np.testing.assert_allclose(
            bilateral.resize_bilinear(torch.from_numpy(img), h, w).numpy(),
            np.asarray(resize(img, h, w)), atol=1e-6)

    levels = [{"grids": rng.normal(1, 0.3, (5, 12, gw, gy, gx)).astype(
        np.float32)} for gx, gy, gw in jbilateral.DEFAULT_MS_GRID]
    rgb = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)

    @jax.jit
    def jax_affines(grids, rgb, nbrs):
        mats = jbilateral.multiscale_affines(
            {"levels": [{"grids": g} for g in grids]}, rgb, 2,
            neighbor_idx=nbrs)
        return mats, jbilateral.compose_affines(mats, rgb)

    for nbrs in (None, [0, 3]):
        jm, jout = jax_affines([l["grids"] for l in levels], rgb,
                               None if nbrs is None else np.asarray(nbrs))
        tm = bilateral.multiscale_affines(
            {"levels": [{"grids": torch.from_numpy(l["grids"])}
                        for l in levels]}, torch.from_numpy(rgb), 2,
            neighbor_idx=nbrs)
        for a, b in zip(jm, tm):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                       rtol=1e-5)
        np.testing.assert_allclose(
            bilateral.compose_affines(tm, torch.from_numpy(rgb)).numpy(),
            np.asarray(jout), atol=1e-5, rtol=1e-5)


def test_render_images_on_a_synthetic_scene():
    """The port's render loop end to end on the CPU: finite images, no
    overflow, test views averaging neighbour grids, and no kernel launch."""
    g = torch.Generator().manual_seed(0)
    scene = synthetic.make_scene(g, num_bg=3000, num_frames=4, num_cams=2,
                                 width=W, height=H, num_rigid=2, rigid_pts=100,
                                 num_deformable=1, deformable_pts=100,
                                 device="cpu")
    data = synthetic.SyntheticData(scene)
    cfg = configs.flagship_config(data.num_images, 4, envlight_resolution=R,
                                  isect_capacity=CAP)
    state, statics = synthetic.random_state(scene, cfg, g, 4096, STEP,
                                            device="cpu")
    nmap = data.neighbor_train_indices(2)
    assert nmap == {4: [2, 6], 5: [3, 7]}
    launches = (expand_cuda.expand_gather.launches,
                rasterize_cuda.rasterize_fwd.launches)
    res = render_loop.render_images(cfg, state, statics, data,
                                    range(data.num_images), nmap)
    assert launches == (expand_cuda.expand_gather.launches,
                        rasterize_cuda.rasterize_fwd.launches)
    for rgb, depth, opac in zip(res["rgbs"], res["depths"], res["opacities"]):
        assert rgb.shape == (H, W, 3)
        assert all(bool(torch.isfinite(x).all()) for x in (rgb, depth, opac))
        assert float(opac.mean()) > 0.1
    assert not any(bool(o) for o in res["overflow"])
    assert all(int(n) > 0 for n in res["num_isects"])


def test_unported_branches_name_their_slice():
    """Every sky model of the JAX trainer is ported (envlight, mlp, none);
    an unknown one raises a ValueError naming them, from the trainer and
    from the set-up."""
    cfg = configs.flagship_config(1, 1, sky_model="cubemap")
    for build in (lambda: trainer.collect_gaussians(
                      cfg, {}, {}, {}, torch.zeros(3), 0, 0, 0.0),
                  lambda: setup.build_models(cfg, "cpu")):
        with pytest.raises(ValueError,
                           match="'cubemap'.*'envlight', 'mlp', 'none'"):
            build()
