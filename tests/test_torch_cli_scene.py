"""The port's scene loader and initial points, KNN scales and Gaussians against
the JAX package on tests/fixtures/proto_scene (helpers in
tests/test_torch_cli.py). Split from that file: the port's test files hold
at most four tests each, bar one parametrized test or tests that share a
module fixture, so that pytest-xdist's count-ordered queue (--dist loadfile)
runs them after tests/test_parallel.py (README).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.core import sampling as jsampling
from bilateral_driving_tpu.data import scene as jscene
from bilateral_driving_tpu.train import setup as jsetup
from bilateral_driving_tpu_torch.core import sampling
from bilateral_driving_tpu_torch.data import scene
from bilateral_driving_tpu_torch.train import setup

from test_torch_cli import PACK, SCENE
from test_torch_threads import one_torch_thread  # noqa: F401


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
