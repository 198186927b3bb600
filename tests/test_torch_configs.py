"""The port's flagship preset against the YAML the JAX package reads, and
the port's independence from JAX, flax, optax and PyYAML."""
import dataclasses
import os
import subprocess
import sys
import textwrap

from bilateral_driving_tpu.tools import common
from bilateral_driving_tpu.utils import config as config_lib
from bilateral_driving_tpu_torch import configs
from bilateral_driving_tpu_torch.train import trainer

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLAGSHIP_YAML = os.path.join(ROOT, "bilateral_driving_tpu", "configs",
                             "omnire_ms_bilateral.yaml")


def test_flagship_preset_equals_yaml():
    cfg = config_lib.load_config(FLAGSHIP_YAML)
    want = common.trainer_config_from(cfg, num_images=240, num_frames=40,
                                      scene_scale=1.0)
    got = configs.flagship_config(240, 40)
    fields = [f.name for f in dataclasses.fields(trainer.TrainerConfig)]
    # every field the port's forward reads exists in the JAX config
    assert all(hasattr(want, name) for name in fields)
    for name in fields:
        assert getattr(got, name) == getattr(want, name), name
    assert configs.FLAGSHIP_BG_CAPACITY == cfg["background_init"]["capacity"]
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
