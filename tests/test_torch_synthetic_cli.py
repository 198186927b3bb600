"""The training CLI's synthetic mode (`--config synthetic`) end to end on
the CPU at a tiny size, its perturbed start, and the TensorBoard event
files it writes (utils/tb.py) against the JAX package's writer, read by
tensorboard's EventAccumulator."""
import importlib.util
import json
import os
import socket
import sys
import types

import numpy as np
import pytest
import torch

from bilateral_driving_tpu.utils import tb as jtb
from bilateral_driving_tpu_torch import configs
from bilateral_driving_tpu_torch.data import synthetic
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.tools import train as train_cli
from bilateral_driving_tpu_torch.train import trainer
from bilateral_driving_tpu_torch.utils import config, tb
from test_torch_threads import one_torch_thread  # noqa: F401

# the synthetic preset at a size that trains on the CPU
TINY = ["data.width=48", "data.height=32", "data.num_frames=3",
        "data.num_bg=100", "data.bg_capacity=128",
        "trainer.envlight_resolution=8", "render.isect_capacity=4096"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _final(run_dir, step):
    return torch.load(os.path.join(run_dir, "checkpoints",
                                   f"checkpoint_{step}.pt"),
                      map_location="cpu", weights_only=False)


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


def test_synthetic_cli_resume_equals_uninterrupted_run(tmp_path):
    """tools.train --config synthetic --device cpu: four steps with the
    live viewer on, a checkpoint after step 2 and a resume from it that
    ends in the same state; the source backup, the TensorBoard scalars of
    the logged steps (every record's CRC checked by tb.read_events), the
    first and last flushed metrics and the frames' metrics."""
    run = TINY + ["trainer.max_steps=4", "logging.log_every=2",
                  "logging.ckpt_every=2"]
    out = str(tmp_path)
    full = train_cli.main(["--config", "synthetic", "--device", "cpu",
                           "--output_root", out, "--run_name", "full",
                           "--viewer_port", str(_free_port()), *run])
    assert full["steps"] == 4 and full["image_hw"] == [32, 48]
    assert full["viewer_frames"] == 0
    assert full["nonfinite_params_max"] == 0
    assert full["first_metrics"]["step"] == 0
    assert full["last_metrics"]["step"] == 3
    run_dir = os.path.join(out, "full")
    assert os.path.exists(os.path.join(run_dir, "backup", "tools",
                                       "train.py"))
    with open(os.path.join(run_dir, "test_metrics.json")) as f:
        assert np.isfinite(json.load(f)["psnr"])
    (events,) = [tb.read_events(os.path.join(run_dir, "tb", name))
                 for name in os.listdir(os.path.join(run_dir, "tb"))]
    assert events[0]["file_version"] == tb.FILE_VERSION
    steps = {}
    for ev in events[1:]:
        for v in ev["values"]:
            steps.setdefault(v["tag"], []).append(ev["step"])
    assert {"loss", "psnr", "num_points/Background"} <= set(steps)
    assert all(s == [0, 2] for s in steps.values())

    resumed = train_cli.main(["--config", "synthetic", "--device", "cpu",
                              "--output_root", out, "--run_name", "resumed",
                              "--resume_from", os.path.join(
                                  run_dir, "checkpoints", "checkpoint_3.pt"),
                              *run])
    assert (resumed["start_step"], resumed["end_step"]) == (3, 4)
    a, b = _final(run_dir, 4), _final(os.path.join(out, "resumed"), 4)
    for k in ("params", "aux", "masks", "stats", "opt", "step", "updates",
              "generator", "extra"):
        _assert_same(a[k], b[k], k)


def test_synthetic_build_perturbs_every_parameter():
    """train.build_synthetic: the targets are the unperturbed build's
    renders in [0, 1]; every floating parameter then moves by a draw of
    0.05 N(0, 1) (mean and spread of the larger leaves)."""
    cfg = config.apply_dotlist(config.wrap(configs.PRESETS["synthetic"]),
                               TINY)
    tcfg, sc, params, statics, aux, masks = common.build_synthetic_scene(
        cfg, 0, "cpu")
    _, frames, _, state = train_cli.build(cfg, 0, torch.device("cpu"))
    assert isinstance(frames, synthetic.RenderedFrames)
    full = trainer.merge_statics(statics, aux)
    with torch.no_grad():
        for f in range(sc.num_frames):
            want = torch.clamp(trainer.forward(
                tcfg, params, full, masks, synthetic.make_batch(sc, f),
                0)["rgb"], 0.0, 1.0)
            assert torch.equal(frames.get_batch(f)["pixels"], want)
    before = dict(trainer.named_leaves(params))
    after = dict(trainer.named_leaves(state.params))
    assert set(before) == set(after) and len(before) >= 10
    for k, p in after.items():
        d = (p.detach() - before[k]).double()
        assert (d != 0).all(), k
        if d.numel() >= 2000:
            assert abs(float(d.mean())) < 0.005, k
            assert 0.045 < float(d.std()) < 0.055, k
    assert train_cli.build(cfg, 0, torch.device("cpu"))[3].params[
        "Background"]["means"].equal(after["Background/means"])


def _accumulate(log_dir):
    # tensorboard reads without TensorFlow (its own stub)
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing import event_accumulator

    acc = event_accumulator.EventAccumulator(
        log_dir, size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    return acc


def test_tb_writer_matches_jax(tmp_path):
    """The same scalar and image calls through the port's TBWriter and the
    JAX package's (torch.utils.tensorboard): the same tags, steps and
    values, and images that decode to the same pixels."""
    import io

    from PIL import Image

    rng = np.random.default_rng(0)
    calls = [("s", {"loss": 0.5, "psnr": 21.25, "lpips": None,
                    "num_points/Background": 300}, 0),
             ("i", "grid", rng.uniform(0, 1, (12, 20, 3)), 0),
             ("s", {"loss": 0.25, "psnr": 23.5}, 20),
             ("i", "grid", rng.uniform(-0.5, 1.5, (12, 20, 3)), 40),
             ("s", {"loss": float(rng.uniform())}, 2 ** 40)]
    readers = []
    for name, writer in (("mine", tb.TBWriter), ("jax", jtb.TBWriter)):
        w = writer(str(tmp_path / name))
        for kind, *args in calls:
            (w.scalars if kind == "s" else w.image)(*args)
        w.close()
        readers.append(_accumulate(str(tmp_path / name)))
    mine, want = readers
    assert mine.Tags()["scalars"] == want.Tags()["scalars"] == [
        "loss", "psnr", "num_points/Background"]
    for tag in want.Tags()["scalars"]:
        assert [(e.step, e.value) for e in mine.Scalars(tag)] == \
            [(e.step, e.value) for e in want.Scalars(tag)], tag
    assert mine.Tags()["images"] == want.Tags()["images"] == ["grid"]
    for a, b in zip(mine.Images("grid"), want.Images("grid"), strict=True):
        assert (a.step, a.width, a.height) == (b.step, b.width, b.height)
        pa, pb = (np.asarray(Image.open(io.BytesIO(e.encoded_image_string)))
                  for e in (a, b))
        np.testing.assert_array_equal(pa, pb)
    # without the wandb package (as here and on the card) both wandb
    # writers stay inactive when enabled
    if importlib.util.find_spec("wandb") is None:
        for writer in (tb.WandbWriter, jtb.WandbWriter):
            w = writer(True, "p", "r", config={}, log_dir=str(tmp_path))
            w.scalars({"loss": 1.0}, 0)
            assert not w.active
    # a flipped bit fails the payload's CRC
    w = tb.TBWriter(str(tmp_path / "x"))
    w.close()
    with open(w.path, "rb") as f:
        blob = bytearray(f.read())
    blob[-5] ^= 1
    (tmp_path / "bad").write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        tb.read_events(str(tmp_path / "bad"))
