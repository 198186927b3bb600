"""The port's SegFormer (models/segformer.py) and sky-mask stage
(preprocess/masks.py) against transformers' SegformerForSemanticSegmentation
as the JAX package's preprocess/masks.py runs it, on a tiny config made
and randomly initialised here (the published b5 checkpoint is not in the
repository): the logits within 1e-5 of the largest, the class maps of
masks.segment_image equal except pixels whose two best upsampled logits
lie within 1e-5 of it (counted); the checkpoint directory transformers'
save_pretrained writes (safetensors or pytorch_model.bin) read by the
port's load_segmenter, and the port's own writer read back; the JAX
package's extract_scene_masks on that directory against the port's CLI
stage, mask for mask."""
import ast
import os

os.environ.setdefault("USE_TF", "0")     # transformers imports faster

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402
from transformers import (SegformerConfig,  # noqa: E402
                          SegformerForSemanticSegmentation,
                          SegformerImageProcessor)

from bilateral_driving_tpu.preprocess import masks as jax_masks  # noqa: E402
import bilateral_driving_tpu_torch  # noqa: E402
from bilateral_driving_tpu_torch import convert  # noqa: E402
from bilateral_driving_tpu_torch.models import segformer  # noqa: E402
from bilateral_driving_tpu_torch.preprocess import \
    cli as port_cli  # noqa: E402
from bilateral_driving_tpu_torch.preprocess import masks  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch_preprocess_trees import assert_trees_equal  # noqa: E402

RTOL = 1e-5
TINY = dict(depths=[1, 2, 1, 1], hidden_sizes=[16, 32, 40, 64],
            num_attention_heads=[1, 2, 5, 8], decoder_hidden_size=32,
            num_labels=19, initializer_range=0.1)
SIZE = {"height": 64, "width": 96}


@pytest.fixture(scope="module")
def hf():
    """transformers' model (random init, seeded) and processor; the
    classifier's sky bias set so that about half the pixels are sky."""
    torch.manual_seed(0)
    model = SegformerForSemanticSegmentation(SegformerConfig(**TINY)).eval()
    proc = SegformerImageProcessor(size=SIZE)
    img = _images(1)[0]
    with torch.no_grad():
        logits = model(**proc(images=img, return_tensors="pt")).logits[0]
        others = torch.cat([logits[:10], logits[11:]]).amax(0)
        model.decode_head.classifier.bias[10] += float(
            (others - logits[10]).median())
    return model, proc


def _images(n: int):
    rng = np.random.default_rng(7)
    shapes = [(45, 80), (64, 96), (90, 160), (37, 61)]
    return [rng.integers(0, 256, shapes[i % 4] + (3,), dtype=np.uint8)
            for i in range(n)]


def _port(model):
    """The port's network with transformers' weights."""
    cfg = segformer.SegformerConfig.from_dict(model.config.to_dict())
    net = segformer.SegformerForSemanticSegmentation(cfg)
    net.load_state_dict(convert.segformer_params_from_hf(
        {k: v.numpy() for k, v in model.state_dict().items()}))
    return net.eval()


def test_logits_and_maps_match_transformers(hf):
    # the port's network is its own: no module of the port imports
    # transformers
    root = os.path.dirname(bilateral_driving_tpu_torch.__file__)
    for d, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(d, name)) as f:
                    tree = ast.parse(f.read())
                imported = [a.name for n in ast.walk(tree)
                            if isinstance(n, ast.Import) for a in n.names]
                imported += [n.module or "" for n in ast.walk(tree)
                             if isinstance(n, ast.ImportFrom)]
                assert not any(m.split(".")[0] == "transformers"
                               for m in imported), name
    model, proc = hf
    net, pp = _port(model), masks.ImageProcessor(size=(64, 96))
    near_ties = 0
    for img in _images(4):
        x = proc(images=img, return_tensors="pt")["pixel_values"]
        assert torch.equal(pp(img), x)
        with torch.no_grad():
            want, got = model(pixel_values=x).logits, net(x)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= RTOL * scale
        seg_want = jax_masks.segment_image(model, proc, img)
        seg_got = masks.segment_image(net, pp, img)
        diff = seg_want != seg_got
        if diff.any():
            up = torch.nn.functional.interpolate(
                want, size=img.shape[:2], mode="bilinear",
                align_corners=False)[0].numpy()
            top2 = np.sort(up[:, diff], axis=0)[-2:]
            assert np.all(top2[1] - top2[0] <= RTOL * scale)
        near_ties += int(diff.sum())
        assert len(np.unique(seg_want)) > 2
    assert near_ties <= 10


@pytest.mark.parametrize("safe", [True, False])
def test_checkpoint_directories(hf, tmp_path, safe):
    model, proc = hf
    d = str(tmp_path / "ckpt")
    model.save_pretrained(d, safe_serialization=safe)
    proc.save_pretrained(d)
    net, pp = masks.load_segmenter(d, device="cpu")
    assert pp == masks.ImageProcessor(size=(64, 96))
    x = proc(images=_images(1)[0], return_tensors="pt")["pixel_values"]
    with torch.no_grad():
        want = model(pixel_values=x).logits
        assert float((net(x) - want).abs().max()) <= RTOL * float(
            want.abs().max())
    # the port's own writer, read back; and a hub name with no directory
    d2 = masks.write_checkpoint(str(tmp_path / "own"), net.config, net, pp)
    net2, pp2 = masks.load_segmenter(d2, device="cpu")
    assert pp2 == pp and all(torch.equal(a, b) for a, b in zip(
        net.state_dict().values(), net2.state_dict().values()))
    with pytest.raises(RuntimeError, match="not available locally"):
        masks.load_segmenter(masks.DEFAULT_CHECKPOINT, device="cpu")


def test_sky_masks_match_jax(hf, tmp_path):
    model, proc = hf
    ckpt = str(tmp_path / "ckpt")
    model.save_pretrained(ckpt)
    proc.save_pretrained(ckpt)
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side / "000" / "images")
        for i, img in enumerate(_images(4)):
            Image.fromarray(img).save(
                tmp_path / side / "000" / "images" / f"{i:03d}_0.jpg")
    jax_dir = str(tmp_path / "jax" / "000")
    assert jax_masks.extract_scene_masks(
        jax_dir, model_proc=jax_masks.load_segmenter(ckpt)) == 4
    port_cli.main(["--data_root", "unused", "--target_dir",
                   str(tmp_path / "port"), "--process_keys", "sky_masks",
                   "--checkpoint", ckpt, "--device", "cpu"])
    assert assert_trees_equal(jax_dir, str(tmp_path / "port" / "000")) == 8
    sky = np.asarray(Image.open(os.path.join(jax_dir, "sky_masks",
                                             "000_0.png")))
    assert 0.1 < (sky > 0).mean() < 0.9
    # the dynamic classes' masks as well
    mp = masks.load_segmenter(ckpt, device="cpu")
    assert masks.extract_scene_masks(str(tmp_path / "port" / "000"),
                                     write_dynamic=True, model_proc=mp) == 4
    jax_masks.extract_scene_masks(jax_dir, write_dynamic=True,
                                  model_proc=(model, proc))
    assert assert_trees_equal(jax_dir, str(tmp_path / "port" / "000")) == 12
