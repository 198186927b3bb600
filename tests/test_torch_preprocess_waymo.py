"""The port's Waymo lidar and mask math (preprocess/waymo_lidar.py, per
point on the device: here the CPU) against the JAX package's numpy, and
both packages' convert_scene on a TFRecord of frames built in the Waymo
protocol buffers' shape (no waymo_open_dataset here: stand-ins for its
Frame, pickled, and MatrixFloat, np.save bytes). Points within 1e-12 of
the largest coordinate in float64, the .bin within one float32 ulp,
ground labels equal except points within 1e-6 m of the plane's threshold
(counted), every other file equal (tests/torch_preprocess_trees.py)."""
import io
import os
import pickle
import struct
import types
import zlib

import numpy as np
import pytest
from PIL import Image

from bilateral_driving_tpu.preprocess import waymo as jax_wy
from bilateral_driving_tpu.preprocess import waymo_lidar as jax_wl
from bilateral_driving_tpu_torch.preprocess import waymo as port_wy
from bilateral_driving_tpu_torch.preprocess import waymo_lidar as port_wl
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_preprocess_trees import assert_trees_equal

NS = types.SimpleNamespace
GROUND_TOL = 1e-6


def _ulps(a, b) -> int:
    """Largest distance in float32 ulps between two float32 arrays."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def _range_image(rng, h, w, incl, height=2.0):
    """Beams below the horizon hit a ground `height` below the sensor,
    the rest walls 10-60 m away; a tenth of the returns missing."""
    r = np.where(incl[:, None] < -0.02,
                 height / np.sin(-np.minimum(incl, -1e-3))[:, None],
                 rng.uniform(10.0, 60.0, (h, w)))
    r = np.minimum(r, 75.0) * (1.0 + 1e-3 * rng.standard_normal((h, w)))
    r[rng.random((h, w)) < 0.1] = 0.0
    return r


@pytest.mark.parametrize("pixel_pose", [False, True])
def test_extract_point_cloud(pixel_pose):
    rng = np.random.default_rng(3)
    h, w = 16, 300
    incl = np.sort(rng.uniform(-0.4, 0.05, h))[::-1]
    ext = jax_wl.poses_from_6dof(np.array([0.01, -0.02, 0.3, 1.2, 0.1, 2.0]))
    kw = {}
    if pixel_pose:
        frame = np.array([0.02, 0.01, 1.0, 120.0, -40.0, 3.0])
        kw = {"frame_pose": jax_wl.poses_from_6dof(frame),
              "pixel_pose": jax_wl.poses_from_6dof(
                  frame + 1e-3 * rng.standard_normal((h, w, 6)))}
    r = _range_image(rng, h, w, incl)
    want = jax_wl.extract_point_cloud(r, ext, incl, **kw)
    got = port_wl.extract_point_cloud(r, ext, incl, device="cpu", **kw)
    for a, b in zip(want, got):
        assert b.dtype == np.float64 and b.shape == (h, w, 3)
        assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()
        assert _ulps(a.astype(np.float32), b.astype(np.float32)) <= 1


def _plane(pts):
    """The reference's last plane (normal, threshold) of ground_mask."""
    order = np.argsort(pts[:, 2])
    seeds = pts[pts[:, 2] < pts[order[:20], 2].mean() + 1.2]
    for _ in range(10):
        mean = seeds.mean(axis=0)
        d = seeds - mean
        cov = (d[:, :, None] * d[:, None, :]).mean(axis=0)
        normal = np.linalg.svd(cov.astype(np.float32))[0][:, 2]
        th = 0.3 + normal.dot(mean)
        seeds = pts[(pts @ normal[:, None])[:, 0] < th]
    return normal, th


class _MatrixFloat:
    """waymo_open_dataset's MatrixFloat as the converter reads it: the
    payload here is np.save bytes."""

    def ParseFromString(self, raw):
        arr = np.load(io.BytesIO(raw))
        self.data = arr.reshape(-1).tolist()
        self.shape = NS(dims=list(arr.shape))


class _Frame:
    """waymo_open_dataset's Frame as the converter reads it: the record is
    a pickled stand-in frame."""

    def ParseFromString(self, raw):
        self.__dict__.update(pickle.loads(raw).__dict__)


class _Box(types.SimpleNamespace):
    def ByteSize(self):
        return 1


def _packed(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    return zlib.compress(buf.getvalue())


def _frame(seed: int):
    """A frame of the TOP lidar (rolling-shutter pixel poses, a beam
    table) and FRONT (uniform inclinations), with camera calibrations,
    JPEG images and laser labels."""
    rng = np.random.default_rng(seed)
    pose = jax_wl.poses_from_6dof(np.array(
        [0.01, 0.0, 0.4, 50.0 + seed, 8.0, 1.0]))
    lasers, calibs = [], []
    for name, (h, w) in ((1, (24, 400)), (2, (8, 60))):
        incl = np.sort(rng.uniform(-0.35, 0.04, h))
        ext = jax_wl.poses_from_6dof(np.array(
            [0.0, 0.0, 0.02 * name, 1.4 * (name - 1), 0.0, 2.1]))
        r = _range_image(rng, h, w, incl[::-1], height=2.1)
        img = np.stack([r, rng.uniform(0, 1, (h, w)),
                        rng.uniform(0, 1, (h, w)), np.zeros((h, w))], -1)
        ri = NS(range_image_compressed=_packed(img),
                range_image_pose_compressed=b"",
                range_image_flow_compressed=b"")
        if name == 1:
            six = np.array([0.01, 0.0, 0.4, 50.0, 8.0, 1.0]) \
                + 1e-3 * rng.standard_normal((h, w, 6))
            ri.range_image_pose_compressed = _packed(six)
        lasers.append(NS(name=name, ri_return1=ri))
        calibs.append(NS(
            name=name, extrinsic=NS(transform=ext.reshape(-1).tolist()),
            beam_inclinations=incl.tolist() if name == 1 else [],
            beam_inclination_min=float(incl[0]),
            beam_inclination_max=float(incl[-1])))
    cams, images = [], []
    for name in (1, 2):
        c2v = jax_wl.poses_from_6dof(np.array(
            [0.0, 0.0, 0.6 * (name - 1), 1.5, 0.0, 1.6]))
        cams.append(NS(name=name, width=160, height=96,
                       extrinsic=NS(transform=c2v.reshape(-1).tolist()),
                       intrinsic=[120.0, 120.0, 80.0, 48.0,
                                  0.02, -0.01, 1e-3, -1e-3, 0.0]))
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (96, 160, 3), np.uint8)).save(
            buf, "JPEG")
        images.append(NS(name=name, image=buf.getvalue()))
    labels = []
    for i in range(30):
        box = _Box(center_x=rng.uniform(-5, 40),
                   center_y=rng.uniform(-10, 10), center_z=1.0,
                   length=rng.uniform(1, 5), width=2.0, height=1.8,
                   heading=rng.uniform(-3, 3))
        labels.append(NS(
            type=int(rng.choice([1, 2, 3, 4])), box=box, id=f"obj{i}",
            num_top_lidar_points_in_box=int(rng.integers(0, 3)),
            num_lidar_points_in_box=1,
            metadata=NS(speed_x=rng.uniform(-4, 4), speed_y=0.5)))
    return NS(pose=NS(transform=pose.reshape(-1).tolist()), lasers=lasers,
              context=NS(laser_calibrations=calibs,
                         camera_calibrations=cams),
              images=images, laser_labels=labels)


def test_convert_scene_matches_jax(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    raw.mkdir()
    with open(raw / "segment.tfrecord", "wb") as f:
        for seed in (0, 1):
            rec = pickle.dumps(_frame(seed))
            f.write(struct.pack("<Q", len(rec)) + b"\0" * 4 + rec
                    + b"\0" * 4)
    proto = NS(Frame=_Frame, MatrixFloat=_MatrixFloat)
    outs = []
    for side, mod, kw in (("jax", jax_wy, {}),
                          ("port", port_wy, {"device": "cpu"})):
        monkeypatch.setattr(mod, "_require_proto", lambda: proto)
        outs.append(mod.convert_scene(str(raw), str(tmp_path / side), 0,
                                      **kw))
    # every file but the lidar: poses, intrinsics, images, speed masks of
    # every class set and camera, instances
    lidar = [os.path.join(o, "lidar") for o in outs]
    bins = [[np.fromfile(os.path.join(d, f"{fi:03d}.bin"),
                         np.float32).reshape(-1, 14) for fi in (0, 1)]
            for d in lidar]
    for d in lidar:
        for fi in (0, 1):
            os.remove(os.path.join(d, f"{fi:03d}.bin"))
    assert assert_trees_equal(*outs) == 2 * (1 + 2 + 2 + 3 * 2) + 2 + 2
    masks = [np.asarray(Image.open(os.path.join(
        outs[0], "dynamic_masks", c, f"{fi:03d}_{ci}.png"))).any()
        for c in ("all", "human", "vehicle") for fi in (0, 1)
        for ci in (0, 1)]
    assert sum(masks) >= 6
    # the lidar: one float32 ulp, the ground labels but at the plane
    flips = 0
    for want, got in zip(*bins):
        assert want.shape == got.shape and want.shape[0] > 5000
        cols = [c for c in range(14) if c != 10]
        assert _ulps(want[:, cols], got[:, cols]) <= 1
        normal, th = _plane(want[:, 3:6])
        differ = np.flatnonzero(want[:, 10] != got[:, 10])
        height = want[differ, 3:6].astype(np.float64) @ normal - th
        assert np.all(np.abs(height) <= GROUND_TOL), height
        assert 0.0 < want[:, 10].mean() < 0.9
        flips += len(differ)
    assert flips <= 2 and max(b[:, 10].mean() for b in bins[0]) > 0.2


def test_project_to_image():
    rng = np.random.default_rng(5)
    intr = np.array([500.0, 500.0, 320.0, 240.0, 0.01, -0.002, 1e-3, 2e-3,
                     1e-4])
    c2v = jax_wl.poses_from_6dof(np.array([0.0, 0.02, 0.1, 1.5, 0.0, 1.6]))
    pts = rng.uniform(-20.0, 40.0, (2000, 3))
    want = jax_wl.project_to_image(pts, c2v, intr, 640, 480)
    got = port_wl.project_to_image(pts, c2v, intr, 640, 480, device="cpu")
    ok = want[:, 2] > 0
    assert np.array_equal(want[:, 2], got[:, 2]) and ok.sum() > 500
    assert np.all(np.abs(want - got) <= 1e-12 * np.abs(want))


def test_tfrecord_and_proto_gate(tmp_path):
    path = tmp_path / "x.tfrecord"
    recs = [b"frame0", b"frame1" * 300, b""]
    with open(path, "wb") as f:
        for r in recs:
            f.write(struct.pack("<Q", len(r)) + b"\0" * 4 + r + b"\0" * 4)
    assert list(port_wy.read_tfrecord(str(path))) == recs \
        == list(jax_wy.read_tfrecord(str(path)))
    # without waymo_open_dataset both converters stop at the schema, with
    # the same instruction
    msgs = []
    for mod in (jax_wy, port_wy):
        with pytest.raises(RuntimeError, match="waymo_open_dataset") as e:
            mod.convert_scene(str(tmp_path), str(tmp_path / "out"), 0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
