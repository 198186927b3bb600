"""The port's CLI slice against the JAX package: the configuration tree and
its overrides, the pixel pack, the scene loader, the initial points and
scales, the metrics, and a tiny CPU training run through tools.train that
is checkpointed, resumed and evaluated by tools.eval.

Both sides run on the CPU; inputs come from tests/fixtures/proto_scene or
from numpy with a seed.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bilateral_driving_tpu.core import sampling as jsampling
from bilateral_driving_tpu.data import scene as jscene
from bilateral_driving_tpu.eval import metrics as jmetrics
from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu.train import setup as jsetup
from bilateral_driving_tpu.utils import config as jconfig
from bilateral_driving_tpu_torch import configs
from bilateral_driving_tpu_torch.core import sampling
from bilateral_driving_tpu_torch.data import importance, scene
from bilateral_driving_tpu_torch.eval import metrics
from bilateral_driving_tpu_torch.models import bilateral
from bilateral_driving_tpu_torch.tools import common, eval as eval_cli
from bilateral_driving_tpu_torch.tools import pack_scene, train as train_cli
from bilateral_driving_tpu_torch.train import setup
from bilateral_driving_tpu_torch.utils import config

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLAGSHIP_YAML = os.path.join(ROOT, "bilateral_driving_tpu", "configs",
                             "omnire_ms_bilateral.yaml")
SCENE = os.path.join(ROOT, "tests", "fixtures", "proto_scene")
PACK = os.path.join(ROOT, "tests", "fixtures", "proto_scene_pixels.npz")
# tools/quality_smoke.py's overrides, with its SMPL switch
QUALITY_OVERRIDES = [
    f"data.scene_dir={SCENE}", "data.num_cams=2", "data.cameras=[0,1]",
    "data.test_image_stride=10", "data.downscale=1", "trainer.max_steps=5000",
    "trainer.steps_per_dispatch=8", "trainer.use_smpl=true",
    "smpl.model_path=synthetic", "trainer.sh_degree=2",
    "trainer.sh_degree_interval=500", "trainer.envlight_resolution=64",
    "render.isect_capacity=262144", "render.capacity_policy=rebucket",
    "background_init.capacity=32768",
    "background_init.num_lidar_samples=12000",
    "background_init.num_near_pts=4000", "background_init.num_far_pts=4000",
    "rigid_capacity=4096", "density.warmup_steps=300",
    "density.refine_interval=200", "density.stop_split_at=4000",
    "res_schedule.double_steps=800", "res_schedule.downscale_times=1",
    "logging.ckpt_every=1000000", "logging.vis_freq=0",
    "logging.log_every=240", "logging.metrics_flush_every=240",
    "render.far_plane=1e10", "losses.dynamic_region={w: 0.5, start_from: 7}"]
# a scene small enough to train on the CPU
TINY = [f"data.scene_dir={SCENE}", f"data.pixel_pack={PACK}",
        "data.cameras=[0,1]", "data.num_cams=2", "data.downscale=1",
        "data.test_image_stride=20", "trainer.envlight_resolution=16",
        "background_init.capacity=1024",
        "background_init.num_lidar_samples=400",
        "background_init.num_near_pts=100", "background_init.num_far_pts=100",
        "rigid_capacity=256", "render.isect_capacity=4096"]


def _tree(overrides=()):
    return config.apply_dotlist(config.wrap(configs.FLAGSHIP_TREE),
                                list(overrides))


def test_config_tree_equals_yaml():
    with open(FLAGSHIP_YAML) as f:
        assert configs.FLAGSHIP_TREE == yaml.safe_load(f)


def test_apply_dotlist_matches_jax(tmp_path):
    want = jconfig.apply_dotlist(jconfig.load_yaml(FLAGSHIP_YAML),
                                 QUALITY_OVERRIDES)
    got = _tree(QUALITY_OVERRIDES)
    assert got == want
    assert got.get_path("losses.dynamic_region.start_from") == 7
    # a run's config round-trips through config.json
    path = str(tmp_path / "config.json")
    config.save_config(got, path)
    assert config.load_config(path) == want
    with pytest.raises(ValueError, match="unknown config keys"):
        common.validate_config(_tree(["render.isect_capacty=4"]))


def test_pixel_pack_equals_pil_decode():
    pack = np.load(PACK)
    want = pack_scene.pack_entries(SCENE)
    assert sorted(pack.files) == sorted(want)
    assert len(want) == 60 * 5
    for k, v in want.items():
        assert pack[k].dtype == np.uint8
        np.testing.assert_array_equal(pack[k], v, err_msg=k)


@pytest.fixture(scope="module")
def scenes():
    want = jscene.load_scene(SCENE, cameras=(0, 1))
    got = scene.load_scene(SCENE, cameras=(0, 1), pixel_pack=PACK,
                           device="cpu")
    return want, got


def test_load_scene_matches_jax(scenes, monkeypatch):
    want, got = scenes
    for f in ("images", "sky_masks", "dynamic_masks", "human_masks",
              "vehicle_masks", "cam_to_worlds", "intrinsics",
              "frame_of_image", "cam_of_image", "lidar_depth_maps"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for a, b in zip(got.lidar_points, want.lidar_points, strict=True):
        np.testing.assert_array_equal(a, b)
    for f in ("ids", "class_names", "node_types"):
        assert getattr(got.instances, f) == getattr(want.instances, f)
    for f in ("poses", "sizes", "frame_valid"):
        np.testing.assert_array_equal(getattr(got.instances, f),
                                      getattr(want.instances, f))
    assert (got.num_frames, got.num_cams, got.width, got.height) == (
        want.num_frames, want.num_cams, want.width, want.height)
    assert got.egocar_masks is None and want.egocar_masks is None
    np.testing.assert_array_equal(got.aabb(), want.aabb())
    assert got.scene_radius() == want.scene_radius()
    assert got.split_train_test(10)[1].tolist() == \
        want.split_train_test(10)[1].tolist()
    gn, wn = got.neighbor_train_indices(10), want.neighbor_train_indices(10)
    assert {k: v.tolist() for k, v in gn.items()} == \
        {k: v.tolist() for k, v in wn.items()}
    for idx, ds in ((7, 1), (21, 2)):
        tb, jb = got.get_batch(idx, ds), want.get_batch(idx, ds)
        assert set(tb) == set(jb)
        for k, v in jb.items():
            # img_idx, frame_idx and normed_time are Python scalars here,
            # int32 and float32 arrays there
            t, v = tb[k], np.asarray(v)
            t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(
                t, v.dtype)
            np.testing.assert_array_equal(t, v, err_msg=k)
    # the packed scene loads without PIL
    monkeypatch.setitem(sys.modules, "PIL", None)
    again = scene.load_scene(SCENE, cameras=(0, 1), pixel_pack=PACK,
                             device="cpu")
    np.testing.assert_array_equal(again.images, want.images)


def test_init_points_match_jax(scenes):
    want, got = scenes
    kw = dict(num_samples=5000, num_near=700, num_far=600, seed=3)
    np.testing.assert_array_equal(scene.get_init_background(got, **kw),
                                  jscene.get_init_background(want, **kw))
    pts = scene.get_init_background(got, **kw)
    np.testing.assert_array_equal(scene.lidar_colors_for_points(got, pts),
                                  jscene.lidar_colors_for_points(want, pts))
    for types in ("RigidNodes", ("DeformableNodes", "SMPLNodes")):
        g = scene.get_init_objects(got, types)
        w = jscene.get_init_objects(want, types)
        assert set(g) == set(w)
        assert g["instance_ids"] == w["instance_ids"]
        for k in set(w) - {"instance_ids", "quats"}:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        # the same float32 formula; XLA's CPU rsqrt in the normalisation
        # is not correctly rounded (it differs from 1 / sqrt in 36% of
        # float32 inputs, by an ulp), so unit quaternions agree to 2 ulp
        np.testing.assert_allclose(g["quats"], w["quats"], rtol=0,
                                   atol=2 * np.finfo(np.float32).eps)


def test_knn_scales_match_jax(scenes):
    """Both evaluate d^2 = |q|^2 - 2 q.r + |r|^2 in float32 and keep the k
    + 1 best; the two frameworks round the norms and the dot product
    differently (XLA fuses them into multiply-adds), and the formula
    cancels for points far from the origin, so each d^2 carries an error of
    a few float32 ulps of |q|^2 + |r|^2. A mean of k distances then moves
    by at most 8 eps (|q|^2 + R^2) / (2 d), R the largest reference norm:
    the tolerance below, per point. (A uniform 1e-6 relative tolerance does
    not follow from this arithmetic: the far sphere points at 100-300 m
    differ by up to 5%.)"""
    _, got = scenes
    pts = scene.get_init_background(got, num_samples=2500, num_near=300,
                                    num_far=200)
    eps = np.finfo(np.float32).eps
    sq = np.sum(pts.astype(np.float64) ** 2, axis=-1)
    for max_ref in (100_000, 1_000):
        want = np.asarray(jsampling.knn_mean_distance(
            jnp.asarray(pts), k=3, max_reference=max_ref), np.float64)
        mine = sampling.knn_mean_distance(torch.from_numpy(pts), k=3,
                                          max_reference=max_ref).numpy()
        tol = 8 * eps * (sq + sq.max()) / (2 * want)
        assert np.all(np.abs(mine - want) <= tol)
        # most points sit close enough to agree to the last bits
        assert np.mean(np.abs(mine - want) <= 1e-6 * want) > 0.5
    np.testing.assert_array_equal(
        setup.knn_scales(torch.from_numpy(pts)).numpy(),
        np.maximum(sampling.knn_mean_distance(torch.from_numpy(pts)).numpy(),
                   1e-7))


def test_gaussian_init_matches_jax(scenes):
    """Everything but the random quaternions equals the JAX builder's."""
    _, got = scenes
    pts = scene.get_init_background(got, num_samples=800, num_near=100,
                                    num_far=100)
    colors = scene.lidar_colors_for_points(got, pts)
    want, wmask = jsetup.build_background(
        jax.random.key(0), 1500, jnp.asarray(pts), jnp.asarray(colors))
    mine, mask = setup.build_background(
        torch.Generator().manual_seed(0), 1500, torch.from_numpy(pts),
        torch.from_numpy(colors))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    for k in ("means", "logit_opacities", "sh_dc", "sh_rest"):
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the scales are the KNN scales (held against the JAX package above)
    scales = setup.knn_scales(torch.from_numpy(pts))
    np.testing.assert_array_equal(
        mine["log_scales"][:len(pts)].numpy(),
        torch.log(scales)[:, None].expand(-1, 3).numpy())
    assert not mine["log_scales"][len(pts):].any()
    q = mine["quats"].numpy()
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(q[len(pts):], np.asarray(want["quats"])[
        len(pts):])


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    h, w = 40, 56
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(
        np.float32)
    masks = [(rng.uniform(size=(h, w)) < p).astype(np.float32)
             for p in (0.3, 0.2, 0.1, 0.0)]
    got = metrics.image_metrics(pred, gt, *masks)
    want = jmetrics.image_metrics(pred, gt, *masks)
    assert set(got) == set(want) and "vehicle_psnr" not in got
    for k in want:
        # SSIM: the same 11 x 11 Gaussian filter, summed in other orders
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    depth = rng.uniform(1, 60, (h, w)).astype(np.float32)
    lidar = np.where(rng.uniform(size=(h, w)) < 0.1,
                     depth + rng.normal(0, 1, (h, w)), 0).astype(np.float32)
    K = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [1.0, -2.0, 3.0]
    assert metrics.depth_metrics(depth, lidar) == \
        jmetrics.depth_metrics(depth, lidar)
    pd = metrics.depth_to_points(depth * (lidar > 0), K, c2w)
    pg = metrics.depth_to_points(lidar, K, c2w)
    np.testing.assert_array_equal(
        pd, jmetrics.depth_to_points(depth * (lidar > 0), K, c2w))
    for pct in (None, 97):
        assert metrics.chamfer_distance(pd, pg, pct) == \
            jmetrics.chamfer_distance(pd, pg, pct)
    classes = {"dynamic": masks[0], "human": masks[3]}
    assert metrics.per_class_chamfer(depth, lidar, K, c2w, classes) == \
        jmetrics.per_class_chamfer(depth, lidar, K, c2w, classes)
    assert metrics.lpips(pred, gt) is None


def test_color_correct_matches_jax():
    rng = np.random.default_rng(5)
    ref = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    img = np.clip(0.8 * ref ** 1.2 + 0.05 + rng.normal(0, 0.02, ref.shape),
                  0, 1).astype(np.float32)
    want = np.asarray(jbilateral.color_correct(jnp.asarray(img),
                                               jnp.asarray(ref)))
    got = bilateral.color_correct(torch.from_numpy(img),
                                  torch.from_numpy(ref)).numpy()
    # both solve the same 10-column least squares in float32 through
    # different factorisations (JAX's SVD solver, torch's pseudo-inverse):
    # a few float32 ulps of the unit-range colours
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sampler_state_round_trips():
    a = importance.ImageSampler(20, 2, start_enhance_weight=3.0, seed=1)
    for i in range(20):
        a.update_error(i, 0.1 + i)
    [a.propose(np.arange(20)) for _ in range(5)]
    b = importance.ImageSampler(20, 2, start_enhance_weight=3.0, seed=9)
    b.load_state_dict(a.state_dict())
    assert [a.propose(np.arange(20)) for _ in range(30)] == \
        [b.propose(np.arange(20)) for _ in range(30)]


def _final(run_dir):
    ck = torch.load(os.path.join(run_dir, "checkpoints", "checkpoint_6.pt"),
                    weights_only=False)
    return ck


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_same(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_cli_resume_equals_uninterrupted_run(tmp_path):
    """Six steps, two per window, across a resolution-schedule change
    (steps 0-2 at half size), a refine at step 4 and a checkpoint after
    step 3; resuming from that checkpoint ends in the same state. Then
    tools.eval writes finite metrics."""
    run = TINY + ["trainer.max_steps=6", "trainer.steps_per_dispatch=2",
                  "density.warmup_steps=2", "density.refine_interval=4",
                  "res_schedule.double_steps=3",
                  "res_schedule.downscale_times=1", "logging.ckpt_every=3",
                  "logging.log_every=2", "logging.metrics_flush_every=2"]
    out = str(tmp_path)
    full = train_cli.main(["--device", "cpu", "--output_root", out,
                           "--run_name", "full", *run])
    assert full["downscales"] == {"2": 3, "1": 3}
    assert [r["step"] for r in full["refines"]] == [4]
    assert full["nonfinite_params_max"] == 0 and full["overflow_steps"] == 0
    assert all(v == 0 for v in full["launches"].values())
    ckpt = os.path.join(out, "full", "checkpoints", "checkpoint_4.pt")
    resumed = train_cli.main(["--device", "cpu", "--output_root", out,
                              "--run_name", "resumed", "--resume_from", ckpt,
                              *run])
    assert (resumed["start_step"], resumed["end_step"]) == (4, 6)
    assert [{k: r[k] for k in ("step", "after", "dropped")}
            for r in resumed["refines"]] == \
        [{k: r[k] for k in ("step", "after", "dropped")}
         for r in full["refines"]]
    a, b = _final(os.path.join(out, "full")), _final(
        os.path.join(out, "resumed"))
    for k in ("params", "aux", "masks", "stats", "opt", "step", "updates",
              "generator", "extra"):
        _assert_same(a[k], b[k], k)
    with open(os.path.join(out, "full", "config.json")) as f:
        assert json.load(f)["trainer"]["max_steps"] == 6

    got = eval_cli.main(["--log_dir", os.path.join(out, "full"),
                         "--device", "cpu", "--max_images", "1",
                         "--compute_geo"])
    for split in ("test", "full"):
        with open(os.path.join(out, "full", f"metrics_{split}.json")) as f:
            m = json.load(f)
        assert m == got[split]
        assert all(np.isfinite(v) for v in m.values()
                   if isinstance(v, float))
        assert {"psnr", "ssim", "depth_rmse", "chamfer"} <= set(m)
