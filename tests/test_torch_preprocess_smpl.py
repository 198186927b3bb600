"""The port's SMPL track matching (preprocess/smpl_track.py), its 4D-Humans
wrapper (preprocess/hmr_predictor.py) and ego-mask assets
(preprocess/ego_masks.py) against the JAX package's, host-side numpy and
PIL in both: smpl.pkl equal on the JAX tests' tracked_scene, with the
tracks given and through the wrapper with a mocked predictor (its cache
files equal too); the ego-mask placeholders and an imported, resized mask
set equal pixel for pixel. Also the scale initialisation of the small
point classes a converted scene gives (core/sampling.knn_mean_distance on
k = 3 points or fewer), against a plain numpy mean."""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bilateral_driving_tpu.core import sampling as jsampling
from bilateral_driving_tpu.preprocess import ego_masks as jax_em
from bilateral_driving_tpu.preprocess import hmr_predictor as jax_hp
from bilateral_driving_tpu.preprocess import smpl_track as jax_st
from bilateral_driving_tpu_torch.core import sampling
from bilateral_driving_tpu_torch.preprocess import ego_masks as port_em
from bilateral_driving_tpu_torch.preprocess import hmr_predictor as port_hp
from bilateral_driving_tpu_torch.preprocess import smpl_track as port_st
from test_smpl_track import F, tracked_scene  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_preprocess_trees import assert_trees_equal, same


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_smpl_pkl_matches_jax(tracked_scene, tmp_path):  # noqa: F811
    gt_raw, pr_raw = tracked_scene
    paths = [st.process_scene(str(tmp_path / side), gt_raw, F,
                              pred_raw_by_cam=pr_raw)
             for side, st in (("jax", jax_st), ("port", port_st))]
    want, got = (_load(p) for p in paths)
    same(got, want, "smpl.pkl")
    assert sorted(want) == [7, 9] and want[7]["valid_mask"].all()
    # the numpy helpers on their own, on random rotations and gaps
    rng = np.random.default_rng(0)
    rots = port_st._quat_to_mat(port_st._mat_to_quat(
        jax_st.slerp_mats(np.eye(3), np.linalg.qr(
            rng.standard_normal((5, 3, 3)))[0], 0.3)))
    valid = rng.random(5) < 0.5
    valid[2] = True
    for name, args in (("slerp_mats", (rots[:2], rots[2:4], 0.4)),
                       ("interpolate_gaps", (valid, rots, True)),
                       ("detect_breaks_mask", (valid,))):
        same(getattr(port_st, name)(*args), getattr(jax_st, name)(*args),
             name)


def test_hmr_wrapper_mocked_predictor(tracked_scene, tmp_path):  # noqa: F811
    gt_raw, pr_raw = tracked_scene
    calls = {"jax": [], "port": []}
    out = {}
    for side, st, hp in (("jax", jax_st, jax_hp),
                         ("port", port_st, port_hp)):
        scene = str(tmp_path / side)
        os.makedirs(os.path.join(scene, "images"))
        for fi in range(F):
            for cam in (0, 1):
                open(os.path.join(scene, "images", f"{fi:03d}_{cam}.jpg"),
                     "wb").close()

        def predictor(paths, cam, side=side):
            assert len(paths) == F
            calls[side].append(cam)
            return pr_raw[cam]

        out[side] = st.process_scene(scene, gt_raw, F, predictor=predictor)
        assert os.path.exists(hp.cache_path(scene, 1))
        # a re-run is served from the cache
        os.remove(out[side])
        st.process_scene(scene, gt_raw, F)
        assert calls[side] == [0, 1]
    # smpl.pkl and the two cache files
    assert assert_trees_equal(str(tmp_path / "jax" / "humanpose"),
                              str(tmp_path / "port" / "humanpose")) == 3
    with pytest.raises(FileNotFoundError, match="4D-Humans|images"):
        port_st.run_tracker(str(tmp_path / "empty"), [0])
    assert port_hp.frame_paths(str(tmp_path / "port"), 0) == [
        p.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
        for p in jax_hp.frame_paths(str(tmp_path / "jax"), 0)]


def test_ego_masks_match_jax(tmp_path):
    sizes = {0: (96, 64), 1: (80, 48), 2: (40, 30)}
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(0)
    for cam in (0, 2):
        Image.fromarray((rng.random((37, 53)) < 0.3).astype(np.uint8) * 255
                        ).save(src / f"{cam}.png")
    for side, em in (("jax", jax_em), ("port", port_em)):
        d = em.write_placeholders(str(tmp_path / side / "a"), sizes, sizes)
        assert all(em.is_placeholder(os.path.join(d, f"{c}.png"))
                   for c in sizes)
        assert em.import_masks(str(src), str(tmp_path / side / "b"),
                               sizes, sizes) == 2
        assert not em.is_placeholder(os.path.join(
            em.scene_mask_dir(str(tmp_path / side / "b")), "0.png"))
    assert assert_trees_equal(
        str(tmp_path / "jax"), str(tmp_path / "port"),
        text_subs={"bilateral_driving_tpu.preprocess.cli":
                   "bilateral_driving_tpu_torch.preprocess.cli"}) == 6


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5])
def test_knn_mean_distance_small_classes(n):
    """A class of n points with k = 3: each point's mean distance to its
    min(k, n - 1) nearest others (0 for a lone point) against numpy's
    float64 distances, within float32's cancellation in |q|^2 - 2 q.r +
    |r|^2 (test_torch_cli_scene's bound). A converted nuScenes scene gives
    such classes: a far bicycle's three lidar points in DeformableNodes
    once SMPL takes the pedestrians. The JAX package's mean is inf for
    1 <= n <= k (a known divergence, ROADMAP section 3) and equal above k."""
    pts = np.random.default_rng(n).uniform(-2.0, 2.0, (n, 3)).astype(
        np.float32)
    got = sampling.knn_mean_distance(torch.from_numpy(pts), k=3).numpy()
    p64 = pts.astype(np.float64)
    d = np.linalg.norm(p64[:, None] - p64[None], axis=-1)
    want = np.sort(d, axis=1)[:, 1:4].mean(1) if n > 1 else np.zeros(n)
    assert got.shape == (n,) and np.all(np.isfinite(got))
    eps = np.finfo(np.float32).eps
    sq = np.sum(p64 ** 2, axis=-1)
    tol = 8 * eps * (sq + sq.max(initial=0.0)) / (2 * np.maximum(want, 1e-3))
    assert np.all(np.abs(got - want) <= tol)
    if n:
        theirs = np.asarray(jsampling.knn_mean_distance(jnp.asarray(pts),
                                                        k=3))
        if n <= 3:
            assert np.all(np.isinf(theirs))
        else:
            assert np.all(np.abs(got - theirs) <= tol)
