"""The port's nuScenes preprocessing against the JAX package's
(bilateral_driving_tpu/preprocess/, numpy on the CPU): the batched hull
fill bit for bit against `_fill_convex`; the converter, then the CLI
(conversion, ego-mask placeholders, SMPL track matching) on the JAX
tests' raw_scene fixture; and the port's raw-log tool (a small copy of
the scene chip_smoke.py converts at full size) through both CLIs, whose
trees must agree file by file (tests/torch_preprocess_trees.py)."""
import os
import shutil
import sys

import numpy as np

from bilateral_driving_tpu.preprocess import cli as jax_cli
from bilateral_driving_tpu.preprocess import nuscenes as jax_nsc
from bilateral_driving_tpu_torch.data import scene as scene_lib
from bilateral_driving_tpu_torch.preprocess import cli as port_cli
from bilateral_driving_tpu_torch.preprocess import nuscenes as port_nsc
from bilateral_driving_tpu_torch.tools import raw_scene as raw_log
from test_preprocess import raw_scene  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_preprocess_trees import assert_trees_equal

README_SUBS = {"bilateral_driving_tpu.preprocess.cli":
               "bilateral_driving_tpu_torch.preprocess.cli"}
CONVERT = ["images", "calib", "lidar", "dynamic_masks", "objects"]


def _hulls(seed: int, n: int):
    """Hulls of 1-8 random points: general, on integer and on half-integer
    (pixel-centre) coordinates, thin, partly or wholly off a 100 x 90
    image."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pts = rng.uniform(-40.0, 140.0, (rng.integers(1, 9), 2)) \
            * rng.uniform(0.05, 1.0)
        if i % 5 == 0:
            pts = np.round(pts)
        elif i % 5 == 1:
            pts = np.floor(pts) + 0.5
        elif i % 5 == 2:
            pts[:, 1] = pts[0, 1] + 0.01 * pts[:, 0]
        out.append(jax_nsc._convex_hull(pts))
    return out


def _skewed(seed: int, n: int):
    """Triangles on a 1600 x 900 image with an edge along a lattice
    direction of pixel centres, its ends moved by a few thousandths: the
    edge passes within 1e-3 px of hundreds of centres, where the test's
    products (up to ~1e6) must keep a difference of 1e-6 (float32 flips
    about one pixel a triangle)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p0 = np.floor(rng.uniform(0, [400, 225])) + 0.5
        d = rng.integers(1, 4, 2) * rng.choice([-1, 1], 2)
        steps = int(rng.integers(100, 300))
        off = rng.integers(-3, 4, (2, 2)) * 1e-3
        p2 = p0 + steps * 0.5 * d + rng.uniform(20, 80) * rng.choice(
            [-1, 1]) * np.array([-d[1], d[0]])
        out.append(jax_nsc._convex_hull(np.stack(
            [p0 + off[0], p0 + steps * d + off[1], p2])))
    return out


def test_fill_convex_bit_equal():
    for hulls, h, w in ((_hulls(0, 240), 90, 100),
                        (_skewed(0, 40), 900, 1600)):
        want = np.stack([jax_nsc._fill_convex(p, h, w) for p in hulls])
        got = port_nsc.fill_convex(hulls, h, w, "cpu").numpy()
        assert np.array_equal(got, want)
        assert want.any(axis=(1, 2)).sum() > len(hulls) // 3
    h, w = 90, 100
    hulls = _hulls(0, 240)
    want = np.stack([jax_nsc._fill_convex(p, h, w) for p in hulls])
    # planes: the unions of their members, as the converter's all, human
    # and vehicle masks
    planes = np.random.default_rng(1).random((len(hulls), 3)) < 0.3
    got = port_nsc.fill_convex(hulls, h, w, "cpu", planes).numpy()
    for p in range(3):
        assert np.array_equal(got[p], want[planes[:, p]].any(0))


def test_convert_matches_jax(raw_scene, tmp_path):  # noqa: F811
    a = jax_nsc.NuScenesConverter(raw_scene, str(tmp_path / "jax")
                                  ).convert_scene(0)
    b = port_nsc.NuScenesConverter(raw_scene, str(tmp_path / "port"),
                                   device="cpu").convert_scene(0)
    # 6 frames: images, extrinsics, lidar, lidar poses, 3 masks each;
    # intrinsics and 2 instance files
    assert assert_trees_equal(a, b) == 6 * 7 + 3


def _both_clis(tmp_path, monkeypatch, capsys, *argv):
    monkeypatch.setattr(sys, "argv", ["cli", *argv, "--target_dir",
                                      str(tmp_path / "jax")])
    jax_cli.main()
    port_cli.main([*argv, "--target_dir", str(tmp_path / "port"),
                   "--device", "cpu"])
    return capsys.readouterr().out


def test_cli_matches_jax(raw_scene, tmp_path,  # noqa: F811
                         monkeypatch, capsys):
    out = _both_clis(tmp_path, monkeypatch, capsys, "--data_root", raw_scene,
                     "--process_keys", *CONVERT)
    assert "stage convert:" in out and "stage ego_masks:" in out
    scenes = [str(tmp_path / side / "000") for side in ("jax", "port")]
    # tracker outputs of the scene (no pedestrian: every frame empty),
    # then the humanpose stage on both trees
    raw_log.write_humanpose(scenes[0])
    shutil.copytree(os.path.join(scenes[0], "humanpose"),
                    os.path.join(scenes[1], "humanpose"))
    out = _both_clis(tmp_path, monkeypatch, capsys, "--data_root", raw_scene,
                     "--process_keys", "humanpose")
    assert "stage humanpose:" in out
    # the converter's files, an ego mask and its README, the tracker
    # output and smpl.pkl
    assert assert_trees_equal(*scenes, text_subs=README_SUBS) == \
        6 * 7 + 3 + 2 + 2


def test_raw_log_through_both_clis(tmp_path, monkeypatch, capsys):
    root = raw_log.write_raw_log(str(tmp_path / "raw"), seed=0, scale=8)
    _both_clis(tmp_path, monkeypatch, capsys, "--data_root", root,
               "--process_keys", *CONVERT)
    scenes = [str(tmp_path / side / "000") for side in ("jax", "port")]
    raw_log.write_humanpose(scenes[0], seed=0)
    shutil.copytree(os.path.join(scenes[0], "humanpose"),
                    os.path.join(scenes[1], "humanpose"))
    _both_clis(tmp_path, monkeypatch, capsys, "--data_root", root,
               "--process_keys", "humanpose")
    n_frames, n_cams = 11, len(raw_log.CAMERA_RIG)
    # per (frame, camera) an image, an extrinsic and 3 masks; per frame a
    # lidar sweep and its pose; per camera an intrinsic, an ego mask and a
    # tracker output; 2 instance files, the README and smpl.pkl
    assert assert_trees_equal(*scenes, text_subs=README_SUBS) == \
        n_frames * n_cams * 5 + n_frames * 2 + n_cams * 3 + 4
    pts = np.fromfile(os.path.join(scenes[1], "lidar", "000.bin"),
                      np.float32).reshape(-1, 4)
    assert pts.shape[0] == raw_log.BEAMS * (raw_log.AZIMUTHS // 8)
    # the pedestrians are matched to their tracks and load as SMPL poses
    data = scene_lib.load_scene(scenes[1], cameras=(0, 1, 2),
                                dataset="nuscenes", device="cpu",
                                compute_depth_maps=False)
    assert data.num_frames == n_frames
    assert len(data.instances.ids) == raw_log.ANNOTATIONS
    assert len(data.smpl_poses) == 8
    assert all(t["valid"].any() for t in data.smpl_poses.values())
