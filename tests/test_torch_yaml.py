"""The port's YAML reader (utils/config.load_yaml, no PyYAML) and the CLI's
--config_file / --dataset_file: every shipped YAML read as PyYAML's
safe_load reads it (the one place these tests import PyYAML), the 19
dataset presets equal to their rig files, a method file plus a rig plus
overrides merged as the JAX CLI merges them, and what the reader refuses
named by its line."""
import glob
import os

import pytest
import yaml

from bilateral_driving_tpu_torch import configs
from bilateral_driving_tpu_torch.tools import train as train_cli
from bilateral_driving_tpu_torch.utils import config
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = os.path.join(ROOT, "bilateral_driving_tpu", "configs")
FLAGSHIP_YAML = os.path.join(CONFIGS, "omnire_ms_bilateral.yaml")


def test_load_yaml_equals_pyyaml():
    """The 11 method and 19 dataset YAMLs, and text with the forms the
    reader takes: nested and compact sequences, a sequence at its key's
    indent, flow mappings, quoted scalars with #, YAML 1.1 numbers."""
    files = sorted(glob.glob(os.path.join(CONFIGS, "**", "*.yaml"),
                             recursive=True))
    assert len(files) == 30
    for path in files:
        with open(path) as f:
            assert config.load_yaml(path) == yaml.safe_load(f), path
    text = ("a:\n- 1\n- b: 2\n  c: [3, '4']\n-\n  - x\n  - {y: null}\n"
            "k: 'a # b'   # comment\nz: \"q\"\nn:\nm: ~\n"
            "f: [1e3, 1.0e3, .5, 010, 0x1f, yes, Off, -.inf]\n"
            "s:\n  - - 1\n    - 2\n  - 3\n")
    assert config.parse_yaml(text) == yaml.safe_load(text)
    assert config.parse_yaml("# nothing\n") is None


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &x 2\n", 2), ("a: |\n  x\n", 1), ("a: [1,\n  2]\n", 1),
    ("---\na: 1\n", 1), ("a:\n  b: 1\n   c: 2\n", 3), ("a: *x\n", 1),
    ("a: 1\n\tb: 2\n", 2), ("a: 'x\n  y'\n", 1)])
def test_unsupported_yaml_names_its_line(text, line):
    with pytest.raises(config.YAMLError, match=f"<yaml>:{line}: "):
        config.parse_yaml(text)


def test_dataset_presets_equal_their_yamls():
    files = sorted(glob.glob(os.path.join(CONFIGS, "datasets", "*",
                                          "*.yaml")))
    names = [os.path.relpath(f, os.path.join(CONFIGS, "datasets"))[:-5]
             for f in files]
    assert sorted(configs.DATASET_PRESETS) == names
    for name, path in zip(names, files):
        with open(path) as f:
            assert configs.DATASET_PRESETS[name] == yaml.safe_load(f), name


def test_config_file_and_dataset_merge_as_the_jax_cli(tmp_path):
    """--config_file with the flagship YAML builds --config
    omnire_ms_bilateral's tree; a rig comes from --dataset_file, from the
    tree's `dataset` key or from a dataset= override, then the overrides
    win; --config and --config_file exclude each other."""
    tree = lambda *argv: train_cli.config_tree(train_cli.parse_args(
        list(argv)))
    preset = tree("--config", "omnire_ms_bilateral")
    assert tree("--config_file", FLAGSHIP_YAML) == preset == tree()
    rig = os.path.join(CONFIGS, "datasets", "waymo", "3cams.yaml")
    with open(FLAGSHIP_YAML) as f:
        want = config.merge(config.wrap(yaml.safe_load(f)),
                            configs.DATASET_PRESETS["waymo/3cams"])
    want = config.apply_dotlist(want, ["data.downscale=4"])
    assert tree("--config_file", FLAGSHIP_YAML, "--dataset_file", rig,
                "data.downscale=4") == want
    got = tree("--config_file", FLAGSHIP_YAML, "dataset=waymo/3cams",
               "data.downscale=4")
    assert got.pop("dataset") == "waymo/3cams" and got == want
    method = tmp_path / "method.yaml"
    method.write_text("dataset: kitti/2cams\ntrainer:\n  sky_model: mlp\n")
    got = tree("--config_file", str(method))
    assert got["data"] == configs.DATASET_PRESETS["kitti/2cams"]["data"]
    assert got["trainer"] == {"sky_model": "mlp"}
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--config", "omnire", "--config_file",
                              FLAGSHIP_YAML])
