"""Cube-map texture gradient: port of the TPU kernel `splat_grad` of
bilateral_driving_tpu/ops/cubemap.py.

`splat_grad` launches the CUDA kernel `csrc/cubemap_splat.cu` on CUDA
tensors and runs `splat_grad_plain` (the JAX package's scatter formula, as
index_add_) on CPU tensors. ops/cubemap.py's `sample_splat` reaches it
through this module.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def splat_grad_plain(face, u0, v0, fu, fv, g, res: int) -> torch.Tensor:
    """(6 * 3, R, R) texture gradient of bilinear lookups with corner data
    face/u0/v0 (P,) int32, fu/fv (P,) and pixel cotangents g (P, 3);
    pixels with face -1 add nothing."""
    keep = face >= 0
    face, u0, v0 = face[keep].long(), u0[keep].long(), v0[keep].long()
    fu, fv, g = fu[keep][:, None], fv[keep][:, None], g[keep]
    cell = (face * res + v0) * res + u0
    acc = torch.zeros((6 * res * res, 3), dtype=torch.float32,
                      device=g.device)
    acc.index_add_(0, cell, g * (1 - fv) * (1 - fu))
    acc.index_add_(0, cell + 1, g * (1 - fv) * fu)
    acc.index_add_(0, cell + res, g * fv * (1 - fu))
    acc.index_add_(0, cell + res + 1, g * fv * fu)
    return acc.reshape(6, res, res, 3).permute(0, 3, 1, 2).reshape(
        6 * 3, res, res)


def splat_grad(face, u0, v0, fu, fv, g, res: int) -> torch.Tensor:
    """d(loss)/d(texture) as (6 * 3, R, R) (face-major, then channel)."""
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
    dz = torch.zeros((6 * 3, res, res), dtype=torch.float32, device=g.device)
    fn = cuda_build.load("cubemap_splat").splat_grad_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, p, p]
    fn.restype = ctypes.c_int
    cuda_build.check(fn(
        face.data_ptr(), u0.data_ptr(), v0.data_ptr(), fu.data_ptr(),
        fv.data_ptr(), g.data_ptr(), npix, res, dz.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream), "splat_grad")
    splat_grad.launches += 1
    return dz


splat_grad.launches = 0
