"""The render CLI slice against the JAX package: the novel-view
trajectories, the visualization helpers, the turbo colour table, the PNG
writer, and tools.render (and the training CLI's snapshots) end to end on
tests/fixtures/proto_scene on the CPU.

matplotlib and PIL are used here as references only: the port writes PNG
with zlib and struct and colours depth from its own table, since the card
has no matplotlib and the CLI runs there with PIL blocked."""
import json
import os

import matplotlib.cm as cm
import numpy as np
from PIL import Image

from bilateral_driving_tpu.eval import render_loop as jrender_loop
from bilateral_driving_tpu.utils import trajectory as jtrajectory
from bilateral_driving_tpu.utils import visualization as jvis
from bilateral_driving_tpu_torch.eval import render_loop
from bilateral_driving_tpu_torch.tools import render as render_cli
from bilateral_driving_tpu_torch.tools import train as train_cli
from bilateral_driving_tpu_torch.utils import trajectory, visualization
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCENE = os.path.join(ROOT, "tests", "fixtures", "proto_scene")
PACK = os.path.join(ROOT, "tests", "fixtures", "proto_scene_pixels.npz")


def _poses(rng, n):
    """(n, 4, 4) camera-to-worlds along a wavy path, rotations drawn."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = rng.normal(0, 0.3, 3)
        cx, cy, cz = np.cos(a)
        sx, sy, sz = np.sin(a)
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        out[i, :3, :3] = rz @ ry @ rx
        out[i, :3, 3] = [np.sin(i / 3.0), 0.1 * i, 2.0 * i]
    return out.astype(np.float32)


def test_trajectories_match_jax():
    """Every generator and interpolate_poses within 1e-6."""
    rng = np.random.default_rng(0)
    per_cam = {c: _poses(rng, 12) for c in range(3)}
    for name in trajectory.TRAJECTORY_GENERATORS:
        got = trajectory.get_novel_trajectory(per_cam, name, 9)
        want = jtrajectory.get_novel_trajectory(per_cam, name, 9)
        assert got.shape == (9, 4, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    for k in (1, 5):
        np.testing.assert_allclose(
            trajectory.interpolate_poses(per_cam[0][:k], 9),
            jtrajectory.interpolate_poses(per_cam[0][:k], 9), atol=1e-6)


def test_turbo_table_equals_matplotlib():
    x = np.concatenate([np.linspace(0, 1, 4097), [0.5 - 1e-7, 1 - 1e-7]])
    for dt in (np.float32, np.float64):
        np.testing.assert_allclose(visualization.turbo(x.astype(dt)),
                                   cm.turbo(x.astype(dt))[..., :3],
                                   atol=1e-6)
    depth = np.random.default_rng(1).uniform(0, 120, (20, 30)).astype(
        np.float32)
    got = render_loop.depth_visualizer(depth)
    np.testing.assert_allclose(got, jrender_loop.depth_visualizer(depth),
                               atol=1e-6)
    assert got.dtype == np.float32 and got.shape == (20, 30, 3)


def test_visualization_matches_jax():
    """tile_cameras (a known layout and the one-row fallback), error_map,
    snapshot_grid and draw_boxes: equal."""
    rng = np.random.default_rng(2)
    names = ["CAM_FRONT", "CAM_BACK", "CAM_FRONT_LEFT"]
    imgs = [rng.random((8 + 2 * i, 12, 3)).astype(np.float32)
            for i in range(3)]
    for ds in ("nuscenes", None):
        np.testing.assert_array_equal(visualization.tile_cameras(imgs, names,
                                                                 ds),
                                      jvis.tile_cameras(imgs, names, ds))
    pred, gt = imgs[0], rng.random((8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(visualization.error_map(pred, gt),
                                  jvis.error_map(pred, gt))
    out = {"gt_rgbs": [gt, gt], "rgbs": [pred, gt],
           "depths": [rng.uniform(0, 90, (8, 12)).astype(np.float32)] * 2}
    np.testing.assert_array_equal(
        visualization.snapshot_grid(out, names[:2], "nuscenes"),
        jvis.snapshot_grid(out, names[:2], "nuscenes"))
    img = rng.random((40, 60, 3)).astype(np.float32)
    K = np.array([[50.0, 0, 30], [0, 50.0, 20], [0, 0, 1]])
    o2ws = _poses(rng, 2)
    o2ws[:, :3, 3] = [[0.5, 0.2, 6.0], [-1.0, 0.0, 0.3]]  # one clipped
    sizes = np.array([[2.0, 1.5, 1.0], [1.0, 1.0, 1.0]])
    np.testing.assert_array_equal(
        visualization.draw_boxes(img, o2ws, sizes, np.eye(4), K),
        jvis.draw_boxes(img, o2ws, sizes, np.eye(4), K))


def test_render_cli_end_to_end(tmp_path):
    """tools.train on the fixture (a snapshot at step 0, vis_freq 2) and
    tools.render --device cpu from its checkpoint: the test and full
    splits, their depth colours and a 5-frame novel trajectory as PNG
    frames of the image size, every novel frame finite, its times and
    launches in render_summary.json."""
    out = str(tmp_path)
    train_cli.main([
        "--config", "pvg", "--device", "cpu", "--output_root", out,
        "--run_name", "r", f"data.scene_dir={SCENE}",
        f"data.pixel_pack={PACK}", "data.cameras=[0,1]", "data.num_cams=2",
        "data.downscale=1", "data.test_image_stride=20",
        "trainer.envlight_resolution=16", "background_init.capacity=1024",
        "background_init.num_lidar_samples=400",
        "background_init.num_near_pts=100", "background_init.num_far_pts=100",
        "render.isect_capacity=4096", "trainer.max_steps=3",
        "res_schedule.downscale_times=0", "logging.vis_freq=2",
        "logging.ckpt_every=1000000"])
    run = os.path.join(out, "r")
    snaps = sorted(os.listdir(os.path.join(run, "images")))
    assert snaps == ["step_0.png", "step_2.png"]
    grid = np.asarray(Image.open(os.path.join(run, "images", snaps[0])))
    assert grid.shape == (4 * 64, 2 * 96, 3)        # gt, rgb, depth, error
    summ = render_cli.main(["--log_dir", run, "--device", "cpu",
                            "--frames", "5"])
    videos = os.path.join(run, "videos")
    counts = {"test": summ["splits"]["test"], "full": 60}
    assert summ["splits"] == counts and summ["novel_frames"] == 5
    for name, n in [("test", counts["test"]), ("test_depth", counts["test"]),
                    ("full", 60), ("full_depth", 60),
                    ("novel_front_center_interp", 5)]:
        files = sorted(os.listdir(os.path.join(videos, name)))
        assert files == [f"{i:04d}.png" for i in range(n)], name
        a = np.asarray(Image.open(os.path.join(videos, name, files[-1])))
        assert a.shape == (64, 96, 3), name
    assert summ["novel_finite"] and summ["size"] == [64, 96]
    assert len(summ["novel_ms"]) == len(summ["novel_launches"]) == 5
    with open(os.path.join(videos, "render_summary.json")) as f:
        assert json.load(f)["novel_frames"] == 5
