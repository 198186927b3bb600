"""Sky / dynamic mask extraction with SegFormer (cityscapes semantics).

Port of bilateral_driving_tpu/preprocess/masks.py, the counterpart of the
reference's datasets/tools/extract_masks.py:91-155: runs SegFormer-b5
(cityscapes fine-tuned) over every processed image and writes
`sky_masks/{name}.png` (class 10 = sky) and optionally semantic dynamic
masks `seg_dynamic_masks/{name}.png`.

The network is the port's own (models/segformer.py) on `device` (default
cuda); `transformers` is not used. `load_segmenter` reads a local Hugging
Face checkpoint directory:

    <checkpoint>/config.json               SegformerConfig fields
    <checkpoint>/preprocessor_config.json  optional; else transformers'
                                           SegformerImageProcessor defaults
    <checkpoint>/model.safetensors         or pytorch_model.bin

with the parameters under transformers' names (read by this module's own
safetensors reader, or torch.load(weights_only=True)). The published
checkpoint ("nvidia/segformer-b5-finetuned-cityscapes-1024-1024") is an
external download: given its hub name and no such directory, this raises
with a message naming the files to supply. The image processor is
transformers' (SegformerImageProcessor), on the model's device: PIL's
bilinear resize to the configured size (data/scene.resize, equal to
PIL's), rescale by 1/255 in float64 rounded to float32, then
(x - mean) / std in float32.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

from ..data import scene
from ..models import segformer

CITYSCAPES_SKY = 10
# cityscapes train ids considered dynamic (person, rider, car, truck, bus,
# train, motorcycle, bicycle) — extract_masks.py:118-127
CITYSCAPES_DYNAMIC = (11, 12, 13, 14, 15, 16, 17, 18)
DEFAULT_CHECKPOINT = "nvidia/segformer-b5-finetuned-cityscapes-1024-1024"
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# PIL's resampling filter numbers (preprocessor_config.json's `resample`)
PIL_NEAREST, PIL_BILINEAR = 0, 2


@dataclasses.dataclass
class ImageProcessor:
    """transformers' SegformerImageProcessor, uint8 (H, W, 3) ->
    pixel_values (1, 3, h, w) float32."""
    size: tuple = (512, 512)               # (height, width)
    do_resize: bool = True
    resample: int = PIL_BILINEAR
    do_rescale: bool = True
    rescale_factor: float = 1 / 255
    do_normalize: bool = True
    image_mean: tuple = IMAGENET_MEAN
    image_std: tuple = IMAGENET_STD

    @classmethod
    def from_dict(cls, d: dict) -> "ImageProcessor":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
              if f.name in d and f.name != "size"}
        for k in ("image_mean", "image_std"):
            if k in kw:
                kw[k] = tuple(kw[k]) if isinstance(kw[k], (list, tuple)) \
                    else (kw[k],) * 3
        if "size" in d:
            s = d["size"]
            kw["size"] = ((s["height"], s["width"]) if isinstance(s, dict)
                          else (s, s))
        if kw.get("resample", PIL_BILINEAR) not in (PIL_NEAREST,
                                                    PIL_BILINEAR):
            raise ValueError(f"resample {kw['resample']}: the port resizes "
                             "as PIL's NEAREST (0) or BILINEAR (2)")
        return cls(**kw)

    def __call__(self, image: np.ndarray, device="cpu") -> torch.Tensor:
        """The processed image on `device`; each step there as
        transformers forms it on the host: the resize by data/scene.resize
        (PIL's integer sums, the same bits on every device), the rescale in
        float64 rounded to float32, the normalisation in float32."""
        dev = torch.device(device)
        x = torch.from_numpy(np.array(image, np.uint8)).to(dev)
        if self.do_resize:
            x = scene.resize(x, self.size[::-1],
                             self.resample == PIL_NEAREST)
        if self.do_rescale:
            x = (x.double() * self.rescale_factor).float()
        if self.do_normalize:
            x = x.float()
            x = ((x - torch.tensor(self.image_mean, dtype=torch.float32,
                                   device=dev))
                 / torch.tensor(self.image_std, dtype=torch.float32,
                                device=dev))
        return x.float().permute(2, 0, 1).contiguous()[None]


# --------------------------------------------------------------------------
# checkpoint files
# --------------------------------------------------------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file's tensors (on the CPU): an 8-byte little-endian
    header length, a JSON header of {name: {dtype, shape, data_offsets}}
    (offsets into the bytes after it), the bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        blob = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        dtype = _ST_DTYPES[meta["dtype"]]
        t = torch.frombuffer(bytearray(blob[lo:hi]), dtype=dtype) \
            if hi > lo else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(meta["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write tensors in the .safetensors layout read_safetensors reads."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, offset, blobs = {}, 0, []
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def write_checkpoint(directory: str, cfg: segformer.SegformerConfig,
                     model: torch.nn.Module, processor: ImageProcessor) -> str:
    """A checkpoint directory load_segmenter reads: config.json,
    preprocessor_config.json and model.safetensors of the model's state
    dict."""
    os.makedirs(directory, exist_ok=True)
    conf = dataclasses.asdict(cfg)
    conf.update(model_type="segformer", architectures=[
        "SegformerForSemanticSegmentation"])
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(conf, f, indent=2)
    proc = dataclasses.asdict(processor)
    proc["size"] = {"height": processor.size[0], "width": processor.size[1]}
    proc["image_processor_type"] = "SegformerImageProcessor"
    with open(os.path.join(directory, "preprocessor_config.json"), "w") as f:
        json.dump(proc, f, indent=2)
    write_safetensors(os.path.join(directory, "model.safetensors"),
                      model.state_dict())
    return directory


def load_segmenter(checkpoint: str = DEFAULT_CHECKPOINT, device="cuda"):
    """(model, processor) from a local checkpoint directory, the model in
    eval mode on `device`; or raises with an actionable message. The port
    downloads nothing: the JAX module's `local_only` has no counterpart."""
    from .. import convert

    config_path = os.path.join(checkpoint, "config.json")
    weights = [os.path.join(checkpoint, n)
               for n in ("model.safetensors", "pytorch_model.bin")]
    weights = [w for w in weights if os.path.exists(w)]
    if not os.path.isfile(config_path) or not weights:
        raise RuntimeError(
            f"SegFormer checkpoint '{checkpoint}' not available locally; "
            "pass --checkpoint with a local directory holding config.json "
            "and model.safetensors or pytorch_model.bin (and optionally "
            "preprocessor_config.json), as transformers' save_pretrained "
            "writes them")
    with open(config_path) as f:
        cfg = segformer.SegformerConfig.from_dict(json.load(f))
    proc_path = os.path.join(checkpoint, "preprocessor_config.json")
    proc = ImageProcessor()
    if os.path.exists(proc_path):
        with open(proc_path) as f:
            proc = ImageProcessor.from_dict(json.load(f))
    state = (read_safetensors(weights[0])
             if weights[0].endswith(".safetensors")
             else torch.load(weights[0], map_location="cpu",
                             weights_only=True))
    model = segformer.SegformerForSemanticSegmentation(cfg)
    params = convert.segformer_params_from_hf(
        {k: v.numpy() for k, v in state.items()})
    # a checkpoint may lack only the batch norm's step count, which eval
    # mode never reads
    missing, unexpected = model.load_state_dict(params, strict=False)
    missing = set(missing) - {"decode_head.batch_norm.num_batches_tracked"}
    if missing or unexpected:
        raise RuntimeError(
            f"SegFormer checkpoint '{checkpoint}' does not fit its "
            f"config.json: missing {sorted(missing)[:5]}, unexpected "
            f"{sorted(unexpected)[:5]}")
    return model.to(device).eval(), proc


def segment_image(model, proc, image: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> (H, W) int32 cityscapes train-id map."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        logits = model(proc(image, dev))
        up = torch.nn.functional.interpolate(
            logits, size=image.shape[:2], mode="bilinear",
            align_corners=False)
        return up.argmax(1)[0].cpu().numpy().astype(np.int32)


def extract_scene_masks(scene_dir: str,
                        checkpoint: str = DEFAULT_CHECKPOINT,
                        write_dynamic: bool = False,
                        model_proc: Optional[tuple] = None,
                        device="cuda") -> int:
    """Write sky_masks/ (and optionally seg_dynamic_masks/) for every image
    in a processed scene dir. Returns the number of images processed."""
    from PIL import Image

    model, proc = model_proc or load_segmenter(checkpoint, device=device)
    img_dir = os.path.join(scene_dir, "images")
    sky_dir = os.path.join(scene_dir, "sky_masks")
    os.makedirs(sky_dir, exist_ok=True)
    dyn_dir = os.path.join(scene_dir, "seg_dynamic_masks")
    if write_dynamic:
        os.makedirs(dyn_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(img_dir)):
        stem = os.path.splitext(name)[0]
        img = np.asarray(Image.open(os.path.join(img_dir, name)).convert(
            "RGB"))
        seg = segment_image(model, proc, img)
        sky = (seg == CITYSCAPES_SKY).astype(np.uint8) * 255
        Image.fromarray(sky).save(os.path.join(sky_dir, f"{stem}.png"))
        if write_dynamic:
            dyn = np.isin(seg, CITYSCAPES_DYNAMIC).astype(np.uint8) * 255
            Image.fromarray(dyn).save(os.path.join(dyn_dir, f"{stem}.png"))
        count += 1
    return count
