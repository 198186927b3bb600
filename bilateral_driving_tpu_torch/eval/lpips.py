"""LPIPS (the VGG-16 variant): port of bilateral_driving_tpu/eval/lpips_jax.py.

Inputs in [0, 1] are mapped to [-1, 1], shifted and scaled per channel,
and run through VGG-16's 13 convolutions; the five post-ReLU stages
conv1_2, conv2_2, conv3_3, conv4_3 and conv5_3 are tapped, each tap
unit-normalised over channels, the squared difference of the two images'
taps weighted by a non-negative 1x1 "lin" layer per tap, averaged over
space and summed over taps.

The weights are not in the repository and are not fetched:
`load_weights_npz` reads the npz that tools/export_lpips_weights.py writes
on a machine with the `lpips` package (conv{i}_w OIHW, conv{i}_b,
lin{j}_w (1, C, 1, 1)). `init_random` draws an instance for tests. The
convolutions are torch.nn.functional.conv2d (the JAX package's are
lax.conv, outside any Pallas kernel), run with TF32 off so that a metric
reads as in float32.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# VGG-16's convolutions: (out_channels, a 2x2 max-pool before it)
VGG16_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# the convolutions after whose ReLU a tap is taken
TAP_AFTER = [1, 3, 6, 9, 12]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSParams(NamedTuple):
    convs: List[Tuple[torch.Tensor, torch.Tensor]]  # 13 x (OIHW w, bias)
    lins: List[torch.Tensor]                        # 5 x (C_tap,)


def init_random(generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> LPIPSParams:
    """A random instance (tests and card checks): conv weights and biases
    0.05 N(0, 1), lin weights U(0, 1)."""
    g = generator
    draw = lambda fn, shape: fn(shape, generator=g, dtype=dtype,
                                device=g.device).to(device)
    convs, cin = [], 3
    for cout, _ in VGG16_PLAN:
        convs.append((draw(torch.randn, (cout, cin, 3, 3)) * 0.05,
                      draw(torch.randn, (cout,)) * 0.05))
        cin = cout
    lins = [draw(torch.rand, (VGG16_PLAN[t][0],)) for t in TAP_AFTER]
    return LPIPSParams(convs, lins)


def save_weights_npz(params: LPIPSParams, path: str):
    """Write `params` in tools/export_lpips_weights.py's layout."""
    out = {}
    for i, (w, b) in enumerate(params.convs):
        out[f"conv{i}_w"] = w.detach().cpu().numpy()
        out[f"conv{i}_b"] = b.detach().cpu().numpy()
    for j, lin in enumerate(params.lins):
        out[f"lin{j}_w"] = lin.detach().cpu().numpy().reshape(1, -1, 1, 1)
    np.savez(path, **out)


def load_weights_npz(path: str, device="cpu", dtype=None) -> LPIPSParams:
    """The npz of tools/export_lpips_weights.py: conv{i}_w (O, I, 3, 3),
    conv{i}_b (O,), lin{j}_w (1, C, 1, 1)."""
    z = np.load(path)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)
    convs = [(t(z[f"conv{i}_w"]), t(z[f"conv{i}_b"]))
             for i in range(len(VGG16_PLAN))]
    lins = [t(z[f"lin{j}_w"].reshape(-1)) for j in range(len(TAP_AFTER))]
    return LPIPSParams(convs, lins)


@contextlib.contextmanager
def no_tf32():
    """cuDNN and matmuls in full float32 inside the block (on Hopper they
    default to TF32 for convolutions), the settings restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _vgg_taps(params: LPIPSParams, x: torch.Tensor):
    """x (N, 3, H, W) in [0, 1] -> the five tapped activations."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    x = (2.0 * x - 1.0 - shift[:, None, None]) / scale[:, None, None]
    taps = []
    for i, ((w, b), (_, pool)) in enumerate(zip(params.convs, VGG16_PLAN)):
        if pool:
            x = F.max_pool2d(x, 2, 2)
        x = torch.relu(F.conv2d(x, w, b, padding=1))
        if i in TAP_AFTER:
            taps.append(x)
    return taps


def _unit_norm(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)


def lpips(params: LPIPSParams, pred: torch.Tensor,
          gt: torch.Tensor) -> torch.Tensor:
    """pred, gt (H, W, 3) or (N, H, W, 3) in [0, 1] on the weights' device
    and in their dtype: the LPIPS distance, a scalar or (N,)."""
    squeeze = pred.dim() == 3
    if squeeze:
        pred, gt = pred[None], gt[None]
    with no_tf32():
        ta = _vgg_taps(params, pred.permute(0, 3, 1, 2))
        tb = _vgg_taps(params, gt.permute(0, 3, 1, 2))
        total = 0.0
        for a, b, lin in zip(ta, tb, params.lins):
            d = (_unit_norm(a) - _unit_norm(b)) ** 2
            total = total + torch.mean(
                torch.sum(d * lin[:, None, None], dim=1), dim=(1, 2))
    return total[0] if squeeze else total
