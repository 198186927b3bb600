"""The port's presets against the YAMLs the JAX package reads, and the
port's independence from JAX, flax, optax and PyYAML."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import yaml

from bilateral_driving_tpu.tools import common
from bilateral_driving_tpu.utils import config as config_lib
from bilateral_driving_tpu_torch import configs
from bilateral_driving_tpu_torch.tools import common as port_common
from bilateral_driving_tpu_torch.train import setup, trainer
from bilateral_driving_tpu_torch.utils import config as port_config
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("name", list(configs.PRESETS))
def test_preset_equals_yaml(name):
    """Every preset equals PyYAML's load of its YAML, maps onto the
    TrainerConfig the JAX package builds from that YAML, field by field,
    and is accepted by the trainer and by build_models."""
    path = os.path.join(ROOT, "bilateral_driving_tpu", "configs",
                        f"{name}.yaml")
    with open(path) as f:
        assert configs.PRESETS[name] == yaml.safe_load(f)
    cfg = config_lib.load_config(path)
    want = common.trainer_config_from(cfg, num_images=240, num_frames=40,
                                      scene_scale=1.0)
    got = port_common.trainer_config_from(
        port_config.wrap(configs.PRESETS[name]), 240, 40, 1.0)
    fields = [f.name for f in dataclasses.fields(trainer.TrainerConfig)]
    # every field the port's forward reads exists in the JAX config
    assert all(hasattr(want, f) for f in fields)
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f
    trainer._check_ported(got)
    models = setup.build_models(got, device="cpu")
    assert ("Affine" in models) == (got.affine_model != "none")
    assert ("CamPose" in models) == got.use_camera_opt
    if name == "omnire_ms_bilateral":
        assert configs.flagship_config(240, 40) == got
        assert configs.FLAGSHIP_BG_CAPACITY == \
            cfg["background_init"]["capacity"]
        assert configs.FLAGSHIP_MAX_STEPS == cfg["trainer"]["max_steps"]


def test_port_imports_no_jax_package():
    """Import every module of the port and chip_smoke.py with jax, flax,
    optax and yaml made unimportable; no module of the JAX package may end
    up loaded."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked: {name}")
                return None

        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, ".")
        import bilateral_driving_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = [m for m in sys.modules if m == "bilateral_driving_tpu"
               or m.startswith("bilateral_driving_tpu.")
               or m.split(".")[0] in BLOCKED]
        assert not bad, bad
        assert len(names) > 20, names
        print("ok", len(names))
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")
