"""The port's CLI tools against the JAX package's: the live viewer
(tools/viewer.py), the exports (utils/export.py) and the source backup
(utils/backup.py); resizing at load is in
tests/test_torch_cli_tools_resize.py. Inputs come from numpy seeds; no JAX
compilation beyond an elementwise colour conversion."""
import json
import os
import threading
import time
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from bilateral_driving_tpu.tools import viewer as jviewer
from bilateral_driving_tpu.utils import backup as jbackup
from bilateral_driving_tpu.utils import export as jexport
from bilateral_driving_tpu_torch.tools import viewer
from bilateral_driving_tpu_torch.utils import backup, export
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
INSTANCES = os.path.join(ROOT, "tests", "fixtures", "proto_scene",
                         "instances")


def test_look_at_matches_jax():
    """Camera-to-world of random eyes and targets, atol 1e-6."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        eye, look = rng.normal(0, 5, 3), rng.normal(0, 5, 3)
        np.testing.assert_allclose(viewer._look_at(eye, look),
                                   jviewer._look_at(eye, look), rtol=0,
                                   atol=1e-6)


def _get(port, path, post=False):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=b"" if post else None,
                                 method="POST" if post else "GET")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.headers.get("Content-Type"), r.read()


def test_viewer_serves_page_frames_stats_and_pause():
    """A Viewer on port 0 answers /, /frame (a PNG of the render, its
    pixels x 255 truncated), /stats and POST /pause; wait_if_paused
    blocks until the page resumes training."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    calls = {}

    def render(c2w, t):
        calls["c2w"], calls["t"] = c2w, t
        return torch.from_numpy(img)

    v = viewer.Viewer(render, port=0).start()
    try:
        ctype, page = _get(v.port, "/")
        assert ctype == "text/html" and b"/frame?eye=" in page
        ctype, png = _get(v.port, "/frame?eye=0,-5,0&look=0,0,0&t=0.25")
        assert ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
        assert calls["t"] == 0.25
        np.testing.assert_allclose(calls["c2w"], jviewer._look_at(
            [0, -5, 0], [0, 0, 0]), atol=1e-12)
        start = png.index(b"IDAT") + 4
        n = int.from_bytes(png[start - 8:start - 4], "big")
        rows = np.frombuffer(zlib.decompress(png[start:start + n]),
                             np.uint8).reshape(24, 1 + 32 * 3)
        assert (rows[:, 0] == 0).all()
        np.testing.assert_array_equal(
            rows[:, 1:].reshape(24, 32, 3), (img * 255).astype(np.uint8))

        v.update_stats(step=42, steps_per_s=3.5, num_points=1234, loss=0.125)
        stats = json.loads(_get(v.port, "/stats")[1])
        assert stats == {"step": 42, "steps_per_s": 3.5, "num_points": 1234,
                         "loss": 0.125, "paused": False}
        assert json.loads(_get(v.port, "/pause", post=True)[1])["paused"]
        released = threading.Event()
        waiter = threading.Thread(
            target=lambda: (v.wait_if_paused(0.01), released.set()))
        waiter.start()
        time.sleep(0.1)
        assert not released.is_set()
        assert not json.loads(_get(v.port, "/pause", post=True)[1])["paused"]
        waiter.join(5)
        assert released.is_set() and v.frames_served == 1
        with pytest.raises(urllib.error.HTTPError):
            _get(v.port, "/nothing")
    finally:
        v.stop()


def test_exports_match_jax(tmp_path):
    """Every function of utils/export.py gives the JAX package's file or
    array on inputs drawn from a seed."""
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 3, (50, 3)).astype(np.float32)
    cols = rng.uniform(-0.2, 1.2, (50, 3)).astype(np.float32)
    for colors in (cols, None):
        export.export_points_to_ply(str(tmp_path / "a.ply"), pts, colors)
        jexport.export_points_to_ply(str(tmp_path / "b.ply"), pts, colors)
        assert (tmp_path / "a.ply").read_text() == \
            (tmp_path / "b.ply").read_text()

    params = {"means": rng.normal(0, 3, (64, 3)).astype(np.float32),
              "logit_opacities": rng.normal(0, 2, (64, 1)).astype(np.float32),
              "sh_dc": rng.normal(0, 1, (64, 1, 3)).astype(np.float32)}
    mask = rng.random(64) < 0.7
    n = export.export_gaussians_to_ply(
        str(tmp_path / "g.ply"), {k: torch.from_numpy(v)
                                  for k, v in params.items()},
        torch.from_numpy(mask), alpha_thresh=0.3)
    jexport.export_gaussians_to_ply(str(tmp_path / "h.ply"), params, mask,
                                    alpha_thresh=0.3)
    assert (tmp_path / "g.ply").read_text() == \
        (tmp_path / "h.ply").read_text()
    assert f"element vertex {n}\n" in (tmp_path / "g.ply").read_text()

    depth = np.where(rng.random((48, 64)) < 0.8,
                     rng.uniform(0.05, 90, (48, 64)), 0).astype(np.float32)
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, 3] = rng.normal(0, 2, 3)
    np.testing.assert_array_equal(export.lidar_from_depth(depth, K, c2w),
                                  jexport.lidar_from_depth(depth, K, c2w))

    cloud = np.concatenate([rng.normal(0, 10, (2000, 3)),
                            rng.random((2000, 1))], axis=1)
    for every in (1, 2):
        np.testing.assert_array_equal(
            export.angular_subsample(cloud, 32, 128, every),
            jexport.angular_subsample(cloud, 32, 128, every))

    with open(os.path.join(INSTANCES, "instances_info.json")) as f:
        info = json.load(f)
    with open(os.path.join(INSTANCES, "frame_instances.json")) as f:
        frames = json.load(f)
    w2s = np.linalg.inv(c2w)
    for frame in (0, 3):
        got = export.export_box_corners(frame, info, frames, w2s,
                                        str(tmp_path / "mine"))
        want = jexport.export_box_corners(frame, info, frames, w2s,
                                          str(tmp_path / "jax"))
        assert got == want and got
        name = f"{frame:03d}.json"
        assert (tmp_path / "mine" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


def test_backup_copies_the_same_paths(tmp_path):
    """backup_project over one source tree copies the relative paths the
    JAX package's copies (the port also skips _build, nvcc's output)."""
    src = tmp_path / "src"
    for rel in ("a.py", "b.yaml", "c.md", "d.txt", "pkg/e.py",
                "pkg/__pycache__/f.py", "work_dirs/g.py", ".git/h.py"):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(rel)

    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    mine = backup.backup_project(str(tmp_path / "mine"), str(src))
    want = jbackup.backup_project(str(tmp_path / "jax"), str(src))
    assert listing(mine) == listing(want) == [
        "a.py", "b.yaml", "c.md", os.path.join("pkg", "e.py")]
    assert (tmp_path / "mine" / "backup" / "pkg" / "e.py").read_text() == \
        "pkg/e.py"
    port = backup.backup_project(str(tmp_path / "port"))
    assert os.path.exists(os.path.join(port, "tools", "train.py"))
    assert not any(part in backup.SKIP_DIRS
                   for rel in listing(port) for part in rel.split(os.sep))
