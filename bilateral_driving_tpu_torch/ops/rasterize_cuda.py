"""Tile compositing, forward and backward.

Port of bilateral_driving_tpu/ops/rasterize_pallas.py (`rasterize_fwd`,
`rasterize_bwd`). Each wrapper launches its CUDA kernel (`csrc/rasterize_fwd.cu`,
`csrc/rasterize_bwd.cu`) on CUDA tensors and runs its plain version on CPU
tensors. The plain versions are tiled like the kernels: they walk every
tile's sorted range in the same global 128-aligned chunks and stop a tile at
the same chunk boundary, so the two agree to float32 rounding.

Features: (R >= 10, cap) f32 sorted rows x, y, a, b, c, logop, r, g, b,
depth. Output: (n_tiles, 5, 1024) f32, channels r, g, b, depth numerator,
alpha = 1 - T_final, over the tile's pixels p = py * 32 + px.

Residuals of the backward: n_live (n_tiles,) int32, the chunks each tile
composited before it stopped, and ckpt (slots, 1024) f32, each live chunk's
entry transmittance per pixel at slot ckpt_off[t] + c, where ckpt_off is the
exclusive prefix sum of the tiles' chunk counts (`checkpoint_slots`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .binning import CHUNK, TILE, num_tiles

NFEAT = 10
N_OUT = 5
PIX = TILE * TILE
STOP_T = 1e-4          # a tile stops once no pixel's transmittance is above
ALPHA_THRESH = 1.0 / 255.0
MAX_ALPHA = 0.999


class Tiling(NamedTuple):
    """Per-tile chunk walk shared by the plain versions."""
    start: torch.Tensor   # (n_tiles,) int64 first entry
    end: torch.Tensor     # (n_tiles,) int64 one past the last entry
    fc: torch.Tensor      # (n_tiles,) int64 first global chunk
    px: torch.Tensor      # (PIX,) pixel centres relative to the tile origin
    py: torch.Tensor
    ox: torch.Tensor      # (n_tiles,) tile origins
    oy: torch.Tensor


def _chunk_counts(starts, counts):
    start = starts.long()
    end = start + counts.long()
    fc = torch.div(start, CHUNK, rounding_mode="floor")
    nch = torch.where(counts > 0,
                      torch.div(end + CHUNK - 1, CHUNK,
                                rounding_mode="floor") - fc,
                      torch.zeros_like(fc))
    return start, end, fc, nch


def checkpoint_slots(starts, counts, cap: int):
    """(ckpt_off (n_tiles,) int32, slots): tile t's live chunk c has its
    entry transmittance at slot ckpt_off[t] + c. The tiles' ranges are
    disjoint, so their chunk counts sum to at most cap / 128 + n_tiles,
    which sizes the buffer without reading the counts back."""
    nch = _chunk_counts(starts, counts)[3]
    off = torch.cumsum(nch, 0) - nch
    return off.to(torch.int32), cap // CHUNK + starts.shape[0]


def _tiling(starts, counts, width: int, height: int,
            dtype=torch.float32) -> Tiling:
    ntx, nty = num_tiles(width, height)
    dev = starts.device
    start, end, fc, _ = _chunk_counts(starts, counts)
    p = torch.arange(PIX, device=dev)
    t = torch.arange(ntx * nty, device=dev)
    return Tiling(
        start, end, fc,
        (p % TILE).to(dtype) + 0.5,
        torch.div(p, TILE, rounding_mode="floor").to(dtype) + 0.5,
        ((t % ntx) * TILE).to(dtype),
        (torch.div(t, ntx, rounding_mode="floor") * TILE).to(dtype))


def _chunk_alpha(feats, tl: Tiling, act, c: int):
    """One chunk of the active tiles: (gidx (n, CHUNK) entry indices,
    features (10, n, CHUNK, 1), in-range mask (n, CHUNK), dx, dy and the
    gated alpha, each (n, CHUNK, PIX)), in the kernels' operation order."""
    j = torch.arange(CHUNK, device=feats.device)
    gidx = (tl.fc[act] + c)[:, None] * CHUNK + j
    f = feats[:NFEAT, gidx][..., None]
    inm = (gidx >= tl.start[act, None]) & (gidx < tl.end[act, None])
    dx = tl.px - (f[0] - tl.ox[act, None, None])
    dy = tl.py - (f[1] - tl.oy[act, None, None])
    sigma = (0.5 * f[2] * dx * dx + 0.5 * f[4] * dy * dy
             + f[3] * dx * dy - f[5])
    alpha = torch.clamp(torch.exp(-sigma), max=MAX_ALPHA)
    alpha = torch.where((alpha >= ALPHA_THRESH) & inm[..., None], alpha,
                        torch.zeros((), dtype=alpha.dtype,
                                    device=feats.device))
    return gidx, f, inm, dx, dy, alpha


def _exclusive_transmittance(alpha):
    t_incl = torch.cumprod(1.0 - alpha, dim=1)
    return torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]],
                     dim=1), t_incl[:, -1]


class FwdPlain(NamedTuple):
    img: torch.Tensor        # (n_tiles, 5, 1024)
    n_live: torch.Tensor     # (n_tiles,) int32
    n_blend: torch.Tensor    # () int64 (entry, pixel) pairs past the gate
    ckpt_off: torch.Tensor   # (n_tiles,) int32
    ckpt: torch.Tensor       # (slots, 1024)


def rasterize_fwd_plain(feats, starts, counts, width: int,
                        height: int) -> FwdPlain:
    """The forward with its residuals, and n_blend, the number of
    (entry, pixel) pairs whose alpha passed the 1/255 gate."""
    ntx, nty = num_tiles(width, height)
    n_tiles = ntx * nty
    dev, dt = feats.device, feats.dtype
    tl = _tiling(starts, counts, width, height, dt)
    nch = _chunk_counts(starts, counts)[3]
    ckpt_off, slots = checkpoint_slots(starts, counts, feats.shape[1])
    ckpt = torch.zeros((slots, PIX), dtype=dt, device=dev)

    trans = torch.ones((n_tiles, PIX), dtype=dt, device=dev)
    acc = torch.zeros((n_tiles, NFEAT - 6, PIX), dtype=dt, device=dev)
    n_live = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    n_blend = torch.zeros((), dtype=torch.int64, device=dev)
    live = nch > 0
    c = 0
    while True:
        act = torch.nonzero(live & (c < nch)).squeeze(1)
        if act.numel() == 0:
            break
        ckpt[ckpt_off[act].long() + c] = trans[act]
        _, f, _, _, _, alpha = _chunk_alpha(feats, tl, act, c)
        n_blend += torch.count_nonzero(alpha)
        t_excl, t_last = _exclusive_transmittance(alpha)
        w = alpha * t_excl * trans[act, None, :]
        acc[act] += torch.einsum("nkp,cnk->ncp", w, f[6:NFEAT, ..., 0])
        trans[act] = trans[act] * t_last
        n_live[act] += 1
        live[act] = trans[act].amax(dim=1) > STOP_T
        c += 1
    img = torch.cat([acc, (1.0 - trans)[:, None]], dim=1)
    return FwdPlain(img, n_live, n_blend, ckpt_off, ckpt)


def rasterize_bwd_plain(feats, starts, counts, n_live, ckpt_off, ckpt, gout,
                        width: int, height: int):
    """Per-entry feature gradients (10, cap) from the image cotangent gout
    (n_tiles, 5, 1024): an explicit reverse sweep over each tile's live
    chunks from the checkpointed transmittances, with
    d_alpha = T G - (sum over later entries of w G) / max(1 - alpha, 0.001)
    gated to 0 < alpha < 0.999, then through sigma to the features.
    Entries outside every live chunk stay 0."""
    dev, dt = feats.device, feats.dtype
    tl = _tiling(starts, counts, width, height, dt)
    nl = n_live.long()
    dfeats = torch.zeros((NFEAT, feats.shape[1]), dtype=dt, device=dev)
    carry = torch.zeros_like(gout[:, 0])                   # (n_tiles, PIX)
    top = int(nl.max()) if nl.numel() else 0
    for c in range(top - 1, -1, -1):
        act = torch.nonzero(c < nl).squeeze(1)
        gidx, f, inm, dx, dy, alpha = _chunk_alpha(feats, tl, act, c)
        t_excl, _ = _exclusive_transmittance(alpha)
        trans = t_excl * ckpt[ckpt_off[act].long() + c][:, None, :]
        w = alpha * trans
        g = gout[act]                                      # (n, 5, PIX)
        G = (torch.einsum("cnk,ncp->nkp", f[6:NFEAT, ..., 0], g[:, :4])
             + g[:, 4:5])
        wG = w * G
        # exclusive suffix sums of w G, taken from the end so that a small
        # suffix keeps its own precision
        incl = torch.flip(torch.cumsum(torch.flip(wG, [1]), 1), [1])
        suffix = (torch.cat([incl[:, 1:], torch.zeros_like(incl[:, :1])], 1)
                  + carry[act, None, :])
        one_m = torch.clamp(1.0 - alpha, min=1.0 - MAX_ALPHA)
        d_alpha = trans * G - suffix / one_m
        gate = (alpha > 0.0) & (alpha < MAX_ALPHA)
        zero = torch.zeros((), dtype=dt, device=dev)
        ds = torch.where(gate, -(alpha * d_alpha), zero)
        a, b, cq = f[2], f[3], f[4]
        # selected, not multiplied by the gate: a pair the gate drops adds
        # nothing even where its features are not finite (as in the kernel)
        d = torch.where(gate, torch.stack([
            -(ds * (a * dx + b * dy)), -(ds * (cq * dy + b * dx)),
            ds * (0.5 * dx * dx), ds * (dx * dy), ds * (0.5 * dy * dy), -ds,
        ]), zero).sum(-1)                                  # (6, n, CHUNK)
        d_col = torch.einsum("ncp,nkp->cnk", g[:, :4], w)  # (4, n, CHUNK)
        d = torch.cat([d, d_col])
        dfeats[:, gidx[inm]] = d[:, inm]
        carry[act] += wG.sum(1)
    return dfeats


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P]
_BWD_ARGTYPES = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P]


def _check_inputs(feats, starts, counts, n_tiles: int, what: str):
    cap = feats.shape[1] if feats.dim() == 2 else 0
    if (feats.dtype != torch.float32 or feats.dim() != 2
            or feats.shape[0] < NFEAT or cap % CHUNK != 0
            or not feats.is_contiguous()):
        raise ValueError(f"{what}: need contiguous (>=10, cap) f32 "
                         "features with cap a multiple of 128")
    for x in (starts, counts):
        if (x.dtype != torch.int32 or x.shape != (n_tiles,)
                or not x.is_contiguous()):
            raise ValueError(f"{what}: need contiguous (n_tiles,) int32 "
                             "tile ranges")
    return cap


def rasterize_fwd(feats, starts, counts, width: int, height: int,
                  residuals: bool = False):
    """(n_tiles, 5, 1024) composited tiles from the sorted feature rows and
    per-tile (start, count) ranges; with `residuals`, the tuple
    (img, n_live, ckpt_off, ckpt) the backward takes."""
    if feats.device.type == "cpu":
        out = rasterize_fwd_plain(feats, starts, counts, width, height)
        return ((out.img, out.n_live, out.ckpt_off, out.ckpt) if residuals
                else out.img)
    cuda_build.require_cuda(feats, starts, counts)
    ntx, nty = num_tiles(width, height)
    n_tiles = ntx * nty
    cap = _check_inputs(feats, starts, counts, n_tiles, "rasterize_fwd")
    if feats.data_ptr() % 16:
        raise ValueError("rasterize_fwd: need 16-byte aligned features")
    dev = feats.device
    out = torch.empty((n_tiles, N_OUT, PIX), dtype=torch.float32, device=dev)
    ckpt_off = ckpt = n_live = None
    if residuals:
        ckpt_off, slots = checkpoint_slots(starts, counts, cap)
        ckpt = torch.empty((slots, PIX), dtype=torch.float32, device=dev)
        n_live = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    launch = cuda_build.function("rasterize_fwd", "rasterize_fwd_launch",
                                 _FWD_ARGTYPES)
    cuda_build.check(launch(
        feats.data_ptr(), cap, starts.data_ptr(), counts.data_ptr(), n_tiles,
        ntx, out.data_ptr(), ptr(ckpt_off), ptr(ckpt), ptr(n_live),
        cuda_build.current_stream(dev)), "rasterize_fwd")
    rasterize_fwd.launches += 1
    return (out, n_live, ckpt_off, ckpt) if residuals else out


rasterize_fwd.launches = 0


def rasterize_bwd(feats, starts, counts, n_live, ckpt_off, ckpt, gout,
                  width: int, height: int):
    """(10, cap) per-entry gradients of the sorted features x, y, a, b, c,
    logop, r, g, b, depth from the image cotangent (n_tiles, 5, 1024) and
    the forward's residuals."""
    if feats.device.type == "cpu":
        return rasterize_bwd_plain(feats, starts, counts, n_live, ckpt_off,
                                   ckpt, gout, width, height)
    cuda_build.require_cuda(feats, starts, counts, n_live, ckpt_off, ckpt,
                            gout)
    ntx, nty = num_tiles(width, height)
    n_tiles = ntx * nty
    cap = _check_inputs(feats, starts, counts, n_tiles, "rasterize_bwd")
    for x, dt, shape in ((n_live, torch.int32, (n_tiles,)),
                         (ckpt_off, torch.int32, (n_tiles,)),
                         (gout, torch.float32, (n_tiles, N_OUT, PIX))):
        if x.dtype != dt or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"rasterize_bwd: need a contiguous {shape} "
                             f"{dt} residual or cotangent")
    if (ckpt.dtype != torch.float32 or ckpt.dim() != 2
            or ckpt.shape[1] != PIX or not ckpt.is_contiguous()):
        raise ValueError("rasterize_bwd: need contiguous (slots, 1024) f32 "
                         "checkpoints")
    dev = feats.device
    slots = ckpt.shape[0]
    dfeats = torch.zeros((NFEAT, cap), dtype=torch.float32, device=dev)
    # the kernels' scratch, written before it is read: the live (tile,
    # chunk) list with two tickets, then each live slot's chunk sum (f64)
    # and carry (f32) per pixel
    work = torch.empty(4 + 2 * slots, dtype=torch.int32, device=dev)
    sums = torch.empty((slots, PIX), dtype=torch.float64, device=dev)
    carry = torch.empty((slots, PIX), dtype=torch.float32, device=dev)
    launch = cuda_build.function("rasterize_bwd", "rasterize_bwd_launch",
                                 _BWD_ARGTYPES)
    cuda_build.check(launch(
        feats.data_ptr(), cap, starts.data_ptr(), counts.data_ptr(),
        n_live.data_ptr(), ckpt_off.data_ptr(), ckpt.data_ptr(),
        gout.data_ptr(), n_tiles, ntx, work.data_ptr(), sums.data_ptr(),
        carry.data_ptr(), dfeats.data_ptr(), cuda_build.current_stream(dev)),
        "rasterize_bwd")
    rasterize_bwd.launches += 1
    return dfeats


rasterize_bwd.launches = 0
