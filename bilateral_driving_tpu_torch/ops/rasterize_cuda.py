"""Tile compositing, forward.

Port of bilateral_driving_tpu/ops/rasterize_pallas.py (`rasterize_fwd`).
`rasterize_fwd` launches the CUDA kernel `csrc/rasterize_fwd.cu` on CUDA
tensors and runs `rasterize_fwd_plain` on CPU tensors. The plain version is
tiled like the kernel: it walks every tile's sorted range in the same global
128-aligned chunks and stops a tile at the same chunk boundary, so the two
agree to float32 rounding.

Features: (R >= 10, cap) f32 sorted rows x, y, a, b, c, logop, r, g, b,
depth. Output: (n_tiles, 5, 1024) f32, channels r, g, b, depth numerator,
alpha = 1 - T_final, over the tile's pixels p = py * 32 + px.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .binning import CHUNK, TILE, num_tiles

NFEAT = 10
N_OUT = 5
PIX = TILE * TILE
STOP_T = 1e-4          # a tile stops once no pixel's transmittance is above
ALPHA_THRESH = 1.0 / 255.0
MAX_ALPHA = 0.999


def rasterize_fwd_plain(feats, starts, counts, width: int, height: int):
    """Returns (img (n_tiles, 5, 1024), n_live (n_tiles,) int32, n_blend):
    n_live is the number of chunks each tile composited before it stopped,
    n_blend (a 0-d tensor) the number of (entry, pixel) pairs whose alpha
    passed the 1/255 gate."""
    ntx, nty = num_tiles(width, height)
    n_tiles = ntx * nty
    dev = feats.device
    start = starts.long()
    end = start + counts.long()
    fc = torch.div(start, CHUNK, rounding_mode="floor")
    nch = torch.where(counts > 0,
                      torch.div(end + CHUNK - 1, CHUNK,
                                rounding_mode="floor") - fc,
                      torch.zeros_like(fc))
    p = torch.arange(PIX, device=dev)
    px = (p % TILE).float() + 0.5
    py = torch.div(p, TILE, rounding_mode="floor").float() + 0.5
    t = torch.arange(n_tiles, device=dev)
    ox = ((t % ntx) * TILE).float()
    oy = (torch.div(t, ntx, rounding_mode="floor") * TILE).float()
    j = torch.arange(CHUNK, device=dev)

    trans = torch.ones((n_tiles, PIX), device=dev)
    acc = torch.zeros((n_tiles, NFEAT - 6, PIX), device=dev)
    n_live = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    n_blend = torch.zeros((), dtype=torch.int64, device=dev)
    live = nch > 0
    c = 0
    while True:
        act = torch.nonzero(live & (c < nch)).squeeze(1)
        if act.numel() == 0:
            break
        gidx = (fc[act] + c)[:, None] * CHUNK + j            # (n, CHUNK)
        f = feats[:NFEAT, gidx][..., None]                  # (10, n, CHUNK, 1)
        inm = (gidx >= start[act, None]) & (gidx < end[act, None])
        mx = f[0] - ox[act, None, None]
        my = f[1] - oy[act, None, None]
        dx = px - mx                                        # (n, CHUNK, PIX)
        dy = py - my
        sigma = (0.5 * f[2] * dx * dx + 0.5 * f[4] * dy * dy
                 + f[3] * dx * dy - f[5])
        alpha = torch.clamp(torch.exp(-sigma), max=MAX_ALPHA)
        alpha = torch.where((alpha >= ALPHA_THRESH) & inm[..., None], alpha,
                            torch.zeros((), device=dev))
        n_blend += torch.count_nonzero(alpha)
        t_incl = torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([torch.ones_like(t_incl[:, :1]),
                            t_incl[:, :-1]], dim=1)
        w = alpha * t_excl * trans[act, None, :]
        acc[act] += torch.einsum("nkp,cnk->ncp", w, f[6:NFEAT, ..., 0])
        trans[act] = trans[act] * t_incl[:, -1]
        n_live[act] += 1
        live[act] = trans[act].amax(dim=1) > STOP_T
        c += 1
    img = torch.cat([acc, (1.0 - trans)[:, None]], dim=1)
    return img, n_live, n_blend


def _launcher():
    fn = cuda_build.load("rasterize_fwd").rasterize_fwd_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, i, i, p, p]
    fn.restype = ctypes.c_int
    return fn


def rasterize_fwd(feats, starts, counts, width: int, height: int):
    """(n_tiles, 5, 1024) composited tiles from the sorted feature rows and
    per-tile (start, count) ranges."""
    if feats.device.type == "cpu":
        return rasterize_fwd_plain(feats, starts, counts, width, height)[0]
    cuda_build.require_cuda(feats, starts, counts)
    ntx, nty = num_tiles(width, height)
    n_tiles = ntx * nty
    cap = feats.shape[1] if feats.dim() == 2 else 0
    if (feats.dtype != torch.float32 or feats.dim() != 2
            or feats.shape[0] < NFEAT or cap % CHUNK != 0
            or not feats.is_contiguous()):
        raise ValueError("rasterize_fwd: need contiguous (>=10, cap) f32 "
                         "features with cap a multiple of 128")
    for x in (starts, counts):
        if (x.dtype != torch.int32 or x.shape != (n_tiles,)
                or not x.is_contiguous()):
            raise ValueError("rasterize_fwd: need contiguous (n_tiles,) "
                             "int32 tile ranges")
    out = torch.empty((n_tiles, N_OUT, PIX), dtype=torch.float32,
                      device=feats.device)
    launch = _launcher()
    cuda_build.check(launch(
        feats.data_ptr(), cap, starts.data_ptr(), counts.data_ptr(), n_tiles,
        ntx, out.data_ptr(),
        torch.cuda.current_stream(feats.device).cuda_stream), "rasterize_fwd")
    rasterize_fwd.launches += 1
    return out


rasterize_fwd.launches = 0
