"""The port's CLI slice against the JAX package: the configuration tree and
its overrides, the pixel pack, the scene loader, the initial points and
scales, the metrics, and a tiny CPU training run through tools.train that
is checkpointed, resumed and evaluated by tools.eval.

Both sides run on the CPU; inputs come from tests/fixtures/proto_scene or
from numpy with a seed.
"""
import os

import numpy as np
import pytest
import torch
import yaml

from bilateral_driving_tpu.utils import config as jconfig
from bilateral_driving_tpu_torch import configs
from bilateral_driving_tpu_torch.data import importance
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.tools import pack_scene
from bilateral_driving_tpu_torch.utils import config
from test_torch_threads import one_torch_thread  # noqa: F401

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
