"""Cube-map texture gradient: port of the TPU kernel `splat_grad` of
bilateral_driving_tpu/ops/cubemap.py.

`splat_grad` launches the CUDA kernels of `csrc/cubemap_splat.cu` on CUDA
tensors and runs `splat_grad_plain` (the JAX package's scatter formula, as
index_add_) on CPU tensors. ops/cubemap.py's `sample_splat` reaches it
through this module. Both return the gradient in the texture's own layout,
(6, R, R, 3) contiguous.

On the card every texel is summed in one fixed order: the keys kernel
gives each kept pixel's four corner contributions their texel as key
(`splat_keys_plain` is its PyTorch version), a stable sort groups them by
texel, corner and pixel (`splat_order`), and the sum kernel adds each
texel's run in that order into the dense gradient
(`splat_grad_sorted_plain` is its PyTorch version). So the result repeats
bit for bit from launch to launch, and equals index_add_ on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
_KEYS_ARGTYPES = [_P, _P, _P, _P, _I, _I, _P, _P]
_SUM_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _P, _P]


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


def splat_keys_plain(face, u0, v0, g, res: int) -> torch.Tensor:
    """The keys kernel: (4 P,) int32, key[c * P + p] the texel of pixel
    p's corner c (0: (u0, v0), 1: u0 + 1, 2: v0 + 1, 3: both), or the
    sentinel 6 R^2 where the pixel has face -1 or an all-zero cotangent."""
    on = (face >= 0) & (g != 0).any(dim=1)
    cell = (face * res + v0) * res + u0
    sentinel = torch.full_like(cell, 6 * res * res)
    return torch.cat([torch.where(on, cell + off, sentinel)
                      for off in (0, 1, res, res + 1)])


def splat_order(keys: torch.Tensor):
    """(sorted keys, permutation): a stable sort, so each texel's entries
    run corner by corner and pixel by pixel."""
    return torch.sort(keys, stable=True)


def splat_grad_sorted_plain(keys, order, fu, fv, g, res: int):
    """The sum kernel: each texel's entries of the sorted keys added one by
    one in their order (index_add_ on the CPU adds its rows in order) into
    the dense (6, R, R, 3) gradient."""
    npix = fu.shape[0]
    live = keys < 6 * res * res
    e = order[live]
    corner, p = e // npix, e % npix
    wu, wv = fu[p][:, None], fv[p][:, None]
    a = torch.where((corner & 2 != 0)[:, None], wv, 1 - wv)
    b = torch.where((corner & 1 != 0)[:, None], wu, 1 - wu)
    acc = torch.zeros((6 * res * res, 3), dtype=g.dtype, device=g.device)
    acc.index_add_(0, keys[live].long(), g[p] * a * b)
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
    if 4 * npix >= 2 ** 31 or 6 * res * res >= 2 ** 31:
        raise ValueError("splat_grad: keys must fit int32")
    stream = cuda_build.current_stream(g.device)
    keys = torch.empty(4 * npix, dtype=torch.int32, device=g.device)
    cuda_build.check(cuda_build.function(
        "cubemap_splat", "splat_keys_launch", _KEYS_ARGTYPES)(
        face.data_ptr(), u0.data_ptr(), v0.data_ptr(), g.data_ptr(), npix,
        res, keys.data_ptr(), stream), "splat_grad keys")
    keys, order = splat_order(keys)
    # every element written by the sum kernel; the caching allocator's
    # blocks are aligned far past the 16 bytes its vector stores need
    dz = torch.empty((6, res, res, 3), dtype=torch.float32, device=g.device)
    cuda_build.check(cuda_build.function(
        "cubemap_splat", "splat_sum_launch", _SUM_ARGTYPES)(
        keys.data_ptr(), order.data_ptr(), fu.data_ptr(), fv.data_ptr(),
        g.data_ptr(), npix, res, dz.data_ptr(), stream), "splat_grad sum")
    splat_grad.launches += 1
    return dz


splat_grad.launches = 0
