"""The port's tile parallelism: bands of one image against the JAX
package's tile_sharded_rasterize (four of the conftest's virtual
devices) and against the port's whole render, and the tile and hybrid
(data x tile) training steps on gloo CPU ranks against train_step.

The JAX side renders with `pallas_expand=False` (its XLA expansion), as
the port's forward tests run it (ROADMAP.md, faults found).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import pipeline as jpipeline
from bilateral_driving_tpu.parallel import data_parallel as jdp
from bilateral_driving_tpu.parallel import tile_parallel as jtp
from bilateral_driving_tpu_torch.ops import pipeline
from bilateral_driving_tpu_torch.parallel import tile_parallel
from test_torch_threads import one_torch_thread  # noqa: F401
import torch_parallel_workers as workers

W, H = 64, 96          # three tile rows: four bands of one row, the last
N_BANDS = 4            # wholly past the image


def _scene(n=200, below=0, scale=0.06, opacity=0.7):
    """tests/test_parallel.py's band scene (numpy draws), with `below`
    more Gaussians projecting under the image's last row."""
    rng = np.random.default_rng(3)
    means = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                            rng.uniform(2, 7, (n, 1))], 1)
    if below:
        # y/z = 0.8-1.0 lands 2-18 pixels below the image at f = 57.6
        z = rng.uniform(2, 7, below)
        means = np.concatenate([means, np.stack([
            rng.uniform(-1, 1, below) * z, rng.uniform(0.85, 1.1, below)
            * z, z], 1)])
    m = len(means)
    f = 0.9 * W
    arrays = (means, np.tile([1.0, 0, 0, 0], (m, 1)), np.full((m, 3), scale),
              np.full((m,), opacity), rng.uniform(0, 1, (m, 3)), np.eye(4),
              np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]]))
    return [np.asarray(a, np.float32) for a in arrays]


def _bands(args, n_band, cfg):
    return [tile_parallel.render_band(*args, W, H, cfg, b, n_band)
            for b in range(n_band)]


def _stitch(outs, key):
    return torch.cat([o[key] for o in outs])[:H]


def test_bands_match_jax_tile_sharded_rasterize():
    """Four bands of the port, stitched, against the JAX package's
    band-sharded render on a 4-device mesh: rgb and alpha within the JAX
    package's band tolerance (1e-4; its bands round their means through
    the shifted principal point and give depth more key bits, where the
    port's bands repeat the whole render's rows), num_isects summed and
    radii maxed over the bands equal."""
    s = _scene()
    jcfg = jpipeline.RasterizeConfig(isect_capacity=2 ** 12, interpret=True,
                                     pallas_expand=False)
    mesh = jdp.make_mesh(N_BANDS, axis="tile")
    want = jtp.make_render_fn(mesh, W, H, jcfg)(*map(jnp.asarray, s))
    outs = _bands([torch.from_numpy(x) for x in s], N_BANDS,
                  pipeline.RasterizeConfig(isect_capacity=2 ** 12))
    assert [int(o["info"]["num_isects"]) for o in outs][-1] == 0
    for key in ("rgb", "alpha"):
        np.testing.assert_allclose(_stitch(outs, key).numpy(),
                                   np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)
    assert sum(int(o["info"]["num_isects"]) for o in outs) == \
        int(want["info"]["num_isects"])
    radii = torch.stack([o["info"]["radii"] for o in outs]).amax(0)
    np.testing.assert_array_equal(radii.numpy(),
                                  np.asarray(want["info"]["radii"]))


def test_stitched_bands_equal_the_whole_render():
    """2 and 4 bands stitched against the port's whole render (1e-4, the JAX
    package's tests/test_parallel.py bound) with num_isects and radii
    equal, on a scene with Gaussians just under the image (a band must
    cull them as the whole render does); the per-band losses' gradients
    summed over the bands against the whole image's (atol 2e-3 of the
    largest, rtol 1e-3). On a scene dense enough that tiles stop early,
    each band's radii are the whole render's (it culls against the full
    image) and the stitched bands are the whole render to rounding (1e-6):
    each band's entries keep the whole render's place in the compositing
    chunks, so every tile stops after the same entry."""
    dense = [torch.from_numpy(x) for x in _scene(4000, scale=0.25,
                                                 opacity=0.9)]
    cfg = pipeline.RasterizeConfig(isect_capacity=2 ** 14)
    whole = pipeline.rasterize(*dense, W, H, cfg)
    for n_band in (2, N_BANDS):
        outs = _bands(dense, n_band, cfg)
        assert all(torch.equal(o["info"]["radii"], whole["info"]["radii"])
                   for o in outs if o["info"]["radii"].any())
        for key in ("rgb", "alpha"):
            np.testing.assert_allclose(_stitch(outs, key).numpy(),
                                       whole[key].numpy(), atol=1e-6)

    args = [torch.from_numpy(x) for x in _scene(below=40)]
    cfg = pipeline.RasterizeConfig(isect_capacity=2 ** 12)
    whole = pipeline.rasterize(*args, W, H, cfg)
    for n_band in (2, N_BANDS):
        outs = _bands(args, n_band, cfg)
        for key in ("rgb", "alpha"):
            np.testing.assert_allclose(_stitch(outs, key).numpy(),
                                       whole[key].numpy(), atol=1e-4)
        assert sum(int(o["info"]["num_isects"]) for o in outs) == \
            int(whole["info"]["num_isects"])
        assert torch.equal(torch.stack([o["info"]["radii"] for o in outs])
                           .amax(0), whole["info"]["radii"])

    def grads(render):
        leaves = [args[0].clone().requires_grad_(),
                  args[4].clone().requires_grad_()]
        total = [torch.zeros_like(x) for x in leaves]
        for o in render(leaves):
            loss = (o["rgb"] ** 2).sum() + o["alpha"].sum()
            if loss.requires_grad:
                for t, g in zip(total, torch.autograd.grad(loss, leaves)):
                    t += g
        return total

    swap = lambda leaves: (leaves[0], *args[1:4], leaves[1], *args[5:])
    g_whole = grads(lambda lv: [pipeline.rasterize(*swap(lv), W, H, cfg)])
    for n_band in (2, N_BANDS):
        g_bands = grads(lambda lv: _bands(swap(lv), n_band, cfg))
        for a, b in zip(g_bands, g_whole):
            scale = max(float(b.abs().max()), 1e-6)
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=2e-3 * scale, rtol=1e-3)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-12))


def _assert_grads(got, want, what):
    """tests/test_parallel.py's rule: relative norm < 1e-3 or an absolute
    difference < 1e-6 per leaf."""
    for k in want:
        diff = float((got[k] - want[k]).norm())
        assert _rel(got[k], want[k]) < 1e-3 or diff < 1e-6, (what, k)


def test_tile_and_hybrid_steps_match_train_step(tmp_path):
    """On four gloo ranks, the JAX package's tile-step scene (EnvLight and
    multi-scale grids after the band gather) with one image per tile row:
    each row's tile step (1 x 2) and the 2 x 2 hybrid step. The loss and
    PSNR as train_step's (rtol 1e-5; hybrid: the mean over the images),
    the gradients and screen gradients as the whole image's (hybrid: mean
    and sum over the images) within 1e-3 relative norm (the JAX package's
    rule), rank 0's radii its image's, and the ranks of each step left
    with the same parameter bits. Each tile row also renders its image
    through make_render_fn, within 1e-4 of the whole render."""
    ranks = workers.spawn(workers.tile_case, 4, tmp_path)
    r0, ref = ranks[0], ranks[0]["train_step"]
    for name, images in (("tile", [0]), ("hybrid", [0, 1])):
        got = r0[name]
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(got["metrics"][k], np.mean(
                [ref[i][k] for i in images]), rtol=1e-5, err_msg=name)
        mean = {k: sum(r0["image_grads"][i][k] for i in images)
                / len(images) for k in r0["image_grads"][0]}
        assert any(bool(g.any()) for k, g in mean.items()
                   if k.startswith(("Sky/", "Affine/")))
        _assert_grads(got["grads"], mean, name)
        _assert_grads({"d": got["dummy"]}, {"d": sum(
            r0["image_dummy"][i] for i in images)}, f"{name} screen")
        assert torch.equal(got["radii"], r0["image_radii"][0])
        assert got["metrics"]["nonfinite_params"] == 0
    for r in ranks:
        # make_render_fn over each tile row against the whole render
        for k in ("rgb", "alpha"):
            np.testing.assert_allclose(r["render"][k][0].numpy(),
                                       r["render"][k][1].numpy(), atol=1e-4)
        assert r["render"]["num_isects"][0] == r["render"]["num_isects"][1]
    for r in ranks[1:]:
        assert r["hybrid"]["digests"] == r0["hybrid"]["digests"]
        assert r["hybrid"]["metrics"] == r0["hybrid"]["metrics"]
    assert ranks[1]["tile"]["digests"] == r0["tile"]["digests"]
    assert ranks[3]["tile"]["digests"] == ranks[2]["tile"]["digests"]
