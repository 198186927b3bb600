"""Cube-map texture gradient: port of the TPU kernel `splat_grad` of
bilateral_driving_tpu/ops/cubemap.py.

`splat_grad` launches the CUDA kernel `csrc/cubemap_splat.cu` on CUDA
tensors and runs `splat_grad_plain` (the JAX package's scatter formula, as
index_add_) on CPU tensors. ops/cubemap.py's `sample_splat` reaches it
through this module. Both return the gradient in the texture's own layout,
(6, R, R, 3) contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P]
# the kernel's block counters, one set per (device, stream): zeroed once
# here, left zero by every launch
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _stream_counters(device, stream: int) -> torch.Tensor:
    words = _counters.get((device.index, stream))
    if words is None:
        words = torch.zeros(64, dtype=torch.int32, device=device)
        _counters[(device.index, stream)] = words
    return words


def splat_grad_plain(face, u0, v0, fu, fv, g, res: int) -> torch.Tensor:
    """(6, R, R, 3) texture gradient of bilinear lookups with corner data
    face/u0/v0 (P,) int32, fu/fv (P,) and pixel cotangents g (P, 3);
    pixels with face -1 add nothing."""
    keep = face >= 0
    face, u0, v0 = face[keep].long(), u0[keep].long(), v0[keep].long()
    fu, fv, g = fu[keep][:, None], fv[keep][:, None], g[keep]
    cell = (face * res + v0) * res + u0
    acc = torch.zeros((6 * res * res, 3), dtype=g.dtype, device=g.device)
    acc.index_add_(0, cell, g * (1 - fv) * (1 - fu))
    acc.index_add_(0, cell + 1, g * (1 - fv) * fu)
    acc.index_add_(0, cell + res, g * fv * (1 - fu))
    acc.index_add_(0, cell + res + 1, g * fv * fu)
    return acc.reshape(6, res, res, 3)


def splat_grad(face, u0, v0, fu, fv, g, res: int) -> torch.Tensor:
    """d(loss)/d(texture) as (6, R, R, 3), the texture's layout."""
    if g.device.type == "cpu":
        return splat_grad_plain(face, u0, v0, fu, fv, g, res)
    cuda_build.require_cuda(face, u0, v0, fu, fv, g)
    npix = face.shape[0]
    for x, dt in ((face, torch.int32), (u0, torch.int32), (v0, torch.int32),
                  (fu, torch.float32), (fv, torch.float32)):
        if x.dtype != dt or x.shape != (npix,) or not x.is_contiguous():
            raise ValueError(f"splat_grad: need contiguous (P,) {dt} "
                             "corner data")
    if (g.dtype != torch.float32 or g.shape != (npix, 3)
            or not g.is_contiguous()):
        raise ValueError("splat_grad: need contiguous (P, 3) f32 cotangents")
    # filled by the launch itself; the caching allocator's blocks are
    # aligned far past the 16 bytes its vector stores and adds need
    dz = torch.empty((6, res, res, 3), dtype=torch.float32, device=g.device)
    stream = cuda_build.current_stream(g.device)
    fn = cuda_build.function("cubemap_splat", "splat_grad_launch", _ARGTYPES)
    cuda_build.check(fn(
        face.data_ptr(), u0.data_ptr(), v0.data_ptr(), fu.data_ptr(),
        fv.data_ptr(), g.data_ptr(), npix, res, dz.data_ptr(),
        _stream_counters(g.device, stream).data_ptr(), stream), "splat_grad")
    splat_grad.launches += 1
    return dz


splat_grad.launches = 0
