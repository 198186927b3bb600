"""The decompositions of the expansion and compositing-forward kernels,
modelled in PyTorch and numpy, against the plain versions and the JAX
package.

A CUDA kernel cannot run on the CPU, so its plan is checked here: the
expansion's owner search per 1,024-entry window (csrc/expand.cu) and the
forward's split of each tile's pixels over a cluster of k blocks with one
stop for the tile (csrc/rasterize_fwd.cu). chip_smoke.py holds the kernels
themselves against the plain versions on the card.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import expand_pallas, rasterize_pallas
from bilateral_driving_tpu_torch.ops import (binning, expand_cuda,
                                             rasterize_cuda)
from test_torch_threads import one_torch_thread  # noqa: F401

PIX = rasterize_cuda.PIX
CHUNK = binning.CHUNK


# ---- expansion: one owner search per window

def _warp_owner(offsets, n: int, m: int) -> int:
    """Last i in [0, n) with offsets[i] <= m, 32 pivots a step, as one warp
    of the kernel searches."""
    lo, hi = 0, n
    while hi - lo > 1:
        step = (hi - lo + 31) // 32
        p = lo + np.arange(32) * step
        ok = (p < hi) & (offsets[np.minimum(p, n - 1)] <= m)
        lo += int(np.nonzero(ok)[0].max()) * step
        hi = min(lo + step, hi)
    return lo


def _window_owners(offsets, num_isects: int, cap: int, window: int):
    """Each valid entry's Gaussian as the kernel's blocks find it: the
    window's first and last valid entries searched (g0, g1), then each
    entry's owner by a branch-free binary search in offsets[g0 .. g1].
    Entries at or past num_isects keep 0 (the kernel reads no owner for
    them)."""
    n = offsets.shape[0] - 1
    valid = min(num_isects, cap)
    owners = np.zeros(cap, np.int32)
    for m0 in range(0, cap, window):
        last = min(m0 + window, valid) - 1
        if last < m0:
            continue
        g0, g1 = _warp_owner(offsets, n, m0), _warp_owner(offsets, n, last)
        off = offsets[g0:g1 + 1]
        m = np.arange(m0, last + 1)
        lo = np.zeros_like(m)
        length = g1 - g0 + 1
        while length > 1:
            half = length // 2
            lo = np.where(off[lo + half] <= m, lo + half, lo)
            length -= half
        owners[m0:last + 1] = g0 + lo
    return owners


def _span_table(seed, n, ntx, nty, zero_frac, max_span, cap):
    """Per-Gaussian table (16, n), offsets clamped to cap and num_isects,
    spans up to max_span x max_span tiles of an ntx x nty grid."""
    rng = np.random.default_rng(seed)
    tx0 = rng.integers(0, ntx, n)
    ty0 = rng.integers(0, nty, n)
    sw = np.minimum(rng.integers(1, max_span + 1, n), ntx - tx0)
    sh = np.minimum(rng.integers(1, max_span + 1, n), nty - ty0)
    counts = (sw * sh).astype(np.int64)
    counts[rng.random(n) < zero_frac] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)])
    num_isects = int(offsets[-1])
    offsets = np.minimum(offsets, cap).astype(np.int32)
    feats = rng.normal(size=(10, n)).astype(np.float32)
    feats[9] = rng.uniform(0.5, 50.0, n)
    table = np.concatenate([
        np.stack([tx0, ty0, sw, offsets[:-1]]).astype(np.float32), feats,
        np.stack([np.arange(n), np.zeros(n)]).astype(np.float32)])
    return table, offsets, num_isects


# (seed, Gaussians, tiles x, tiles y, empty share, largest span, capacity
# (None: num_isects itself), window)
EXPAND_CASES = {
    "sparse, 512 slots, 300 live": (0, 512, 3, 2, 212 / 512, 3, 2048, 64),
    "sparse at the kernel's window": (1, 2000, 3, 2, 0.9, 3, 2048, 1024),
    "truncated at cap": (2, 400, 3, 2, 0.0, 3, 256, 64),
    "spans over several windows": (3, 40, 40, 20, 0.3, 20, 4096, 64),
    "one Gaussian": (4, 1, 40, 20, 0.0, 20, 512, 64),
    "num_isects equal to cap": (5, 300, 3, 2, 0.2, 3, None, 64),
    "no entries": (6, 300, 3, 2, 1.0, 3, 512, 64),
}


@pytest.mark.parametrize("case", list(EXPAND_CASES))
def test_expand_window_owners_match_plain_and_xla(case):
    seed, n, ntx, nty, zero_frac, span, cap, window = EXPAND_CASES[case]
    table, offsets, ni = _span_table(seed, n, ntx, nty, zero_frac, span,
                                     cap or 1 << 20)
    cap = cap or ni
    n_tiles = ntx * nty
    valid = min(ni, cap)
    if case == "spans over several windows":
        assert np.diff(offsets).max() > 2 * window
    if case == "truncated at cap":
        assert ni > cap
    owners = _window_owners(offsets, ni, cap, window)
    t_tab, t_off = torch.from_numpy(table), torch.from_numpy(offsets)
    t_ni = torch.tensor(ni, dtype=torch.int32)
    fill = binning.fill_monotone(torch.arange(n, dtype=torch.int32),
                                 t_off[:-1], cap)
    np.testing.assert_array_equal(owners[:valid], fill.numpy()[:valid])
    got = expand_cuda.gather_entries(t_tab, torch.from_numpy(owners), t_ni,
                                     ntx, n_tiles, n)
    plain = expand_cuda.expand_gather_plain(t_tab, t_off, t_ni, cap, ntx,
                                            n_tiles, n)
    xla = expand_pallas.expand_gather_xla(
        jnp.asarray(table), jnp.asarray(offsets), jnp.int32(ni), cap, ntx,
        n_tiles, n)
    for a, b, c in zip(got, plain, xla):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.numpy().view(np.int32))
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(c).view(np.int32))


# ---- compositing forward: one cluster of k blocks per tile

GATE_SIGMA = 5.5413 + 1e-3


def _may_reach(mx, my, ha, b, hc, lg, py):
    """The kernel's may_reach, vectorised: whether an entry (its prepared
    f32 values) may pass the alpha gate at a pixel of the tile row at
    y = py, x = 0.5 .. 31.5; from the least of sigma's quadratic along the
    row, in float64, against the gate plus 1e-5 of the terms' size."""
    mx, my, ha, b, hc, lg = (np.asarray(x, np.float64)
                             for x in (mx, my, ha, b, hc, lg))
    finite = (np.isfinite(mx) & np.isfinite(my) & np.isfinite(ha)
              & np.isfinite(b) & np.isfinite(hc) & np.isfinite(lg))
    with np.errstate(all="ignore"):
        dy = np.float64(py) - my
        lo, hi = 0.5 - mx, 31.5 - mx
        qa, qb, qc = ha, b * dy, hc * dy * dy - lg
        least = np.minimum((qa * lo + qb) * lo + qc, (qa * hi + qb) * hi + qc)
        x = -qb / (2.0 * qa)
        inner = (qa > 0) & (x > lo) & (x < hi)
        least = np.where(inner, np.minimum(least, (qa * x + qb) * x + qc),
                         least)
        d = np.maximum(np.abs(lo), np.abs(hi))
        size = (np.abs(qa) * d * d + np.abs(hc) * dy * dy + np.abs(qb) * d
                + np.abs(lg))
        return ~finite | ~(least > GATE_SIGMA + 1e-5 * size)


def _random_entries(rng, n):
    """Prepared f32 entries (mx, my, a/2, b, c/2, logop) around a tile:
    scales from 0.3 to 60 pixels, every 50th covariance not positive
    definite."""
    f32 = np.float32
    scale = np.exp(rng.uniform(np.log(0.3), np.log(60.0), n))
    mx = rng.uniform(-80, 112, n).astype(f32)
    my = rng.uniform(-80, 112, n).astype(f32)
    ha = (0.5 / scale ** 2 * rng.uniform(0.5, 2.0, n)).astype(f32)
    hc = (0.5 / scale ** 2 * rng.uniform(0.5, 2.0, n)).astype(f32)
    b = (rng.uniform(-0.9, 0.9, n) * 2 * np.sqrt(ha * hc)).astype(f32)
    b[::50] = (rng.uniform(-3, 3, n // 50) * ha[::50]).astype(f32)  # not PD
    lg = np.log(rng.uniform(0.01, 0.999, n)).astype(f32)
    return mx, my, ha, b, hc, lg


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cluster_fwd(feats, starts, counts, width: int, height: int, k: int,
                 cull: bool = True):
    """The forward kernel's walk: block r of tile t's cluster owns pixels
    [r * 1024 / k, (r + 1) * 1024 / k) and composites each chunk entry by
    entry from the prepared entries (mean minus tile origin, a/2, c/2),
    each pixel row only the entries of the tile's range that _may_reach
    it (with `cull` False, every entry of the range). After each chunk
    every block's flag (any own pixel with T > 1e-4) goes to the cluster,
    whose OR of them arrives one chunk late: a tile composites chunk c
    before it learns that it stopped after chunk c - 1, and then puts back
    its state from before chunk c. Returns (img, n_live, ckpt_off, ckpt,
    split), split counting the chunk ends where some block of a going tile
    had no pixel above 1e-4."""
    tl = rasterize_cuda._tiling(starts, counts, width, height)
    nch = rasterize_cuda._chunk_counts(starts, counts)[3]
    ckpt_off, slots = rasterize_cuda.checkpoint_slots(starts, counts,
                                                      feats.shape[1])
    n_tiles = starts.shape[0]
    T = torch.ones((n_tiles, PIX))
    acc = torch.zeros((n_tiles, 4, PIX))
    ckpt = torch.zeros((slots, PIX))
    n_live = torch.zeros(n_tiles, dtype=torch.int32)
    walking = nch > 0                        # no stop learnt yet
    went_on = torch.ones(n_tiles, dtype=torch.bool)   # the OR of chunk c-1
    split = 0
    c = 0
    while True:
        act = torch.nonzero(walking & (c < nch)).squeeze(1)
        if act.numel() == 0:
            break
        ckpt[ckpt_off[act].long() + c] = T[act]
        gidx = (tl.fc[act] + c)[:, None] * CHUNK + torch.arange(CHUNK)
        f = feats[:10, gidx]                                # (10, n, 128)
        inm = (gidx >= tl.start[act, None]) & (gidx < tl.end[act, None])
        mx = f[0] - tl.ox[act, None]
        my = f[1] - tl.oy[act, None]
        ha, hc = 0.5 * f[2], 0.5 * f[4]
        # the entries each pixel's row may reach (the rest are never
        # composited there)
        prow = torch.div(torch.arange(PIX), 32, rounding_mode="floor")
        reach = torch.from_numpy(np.stack([_may_reach(
            mx.numpy(), my.numpy(), ha.numpy(), f[3].numpy(), hc.numpy(),
            f[5].numpy(), r + 0.5) for r in range(32)], -1))  # (n, 128, 32)
        reach = (reach | (not cull)) & inm[..., None]
        t_a, a_a = T[act], acc[act]
        for j in range(CHUNK):
            dx = tl.px - mx[:, j, None]
            dy = tl.py - my[:, j, None]
            sigma = (ha[:, j, None] * dx * dx + hc[:, j, None] * dy * dy
                     + f[3][:, j, None] * dx * dy - f[5][:, j, None])
            e = torch.exp(-sigma)
            alpha = torch.where(e > 0.999, torch.tensor(0.999), e)
            keep = (alpha >= 1.0 / 255.0) & reach[:, j][:, prow]
            w = alpha * t_a
            a_a = torch.where(keep[:, None],
                              a_a + w[:, None] * f[6:10, :, j].T[:, :, None],
                              a_a)
            t_a = torch.where(keep, t_a * (1.0 - alpha), t_a)
        flags = (t_a.view(-1, k, PIX // k) > 1e-4).any(2)  # per block
        # the OR of chunk c - 1 arrives: a tile that stopped there drops
        # chunk c and keeps its state from before it
        kept = went_on[act]
        T[act[kept]], acc[act[kept]] = t_a[kept], a_a[kept]
        n_live[act[kept]] += 1
        walking[act[~kept]] = False
        went_on[act] = flags.any(1)
        split += int((flags.any(1) & ~flags.all(1))[kept].sum())
        c += 1
    img = torch.cat([acc, (1.0 - T)[:, None]], dim=1)
    return img, n_live, ckpt_off, ckpt, split


WIDTH, HEIGHT = 96, 64
NTX, NTY = binning.num_tiles(WIDTH, HEIGHT)


def _fwd_inputs(seed, opaque: bool):
    """Sorted features and tile ranges; with `opaque`, near-opaque wide
    Gaussians that cover every tile but its last pixel row, so the tiles
    stop only on the flag of the cluster's last block."""
    n, cap = (1200, 4096) if opaque else (300, 2048)
    table, offsets, ni = _span_table(seed, n, NTX, NTY, 0.2, 3, cap)
    key, _, feats = expand_cuda.expand_gather(
        torch.from_numpy(table), torch.from_numpy(offsets),
        torch.tensor(ni, dtype=torch.int32), cap, NTX, NTX * NTY, n)
    key_s, perm = torch.sort(key, stable=True)
    starts, counts = binning.tile_ranges(
        binning.tiles_of_keys(key_s, NTX * NTY),
        torch.tensor(ni, dtype=torch.int32), NTX * NTY, cap)
    g = torch.Generator().manual_seed(seed)
    fs = feats[:, perm].clone()
    tile = binning.tiles_of_keys(key_s, NTX * NTY).clamp(max=NTX * NTY - 1)
    ox = (tile % NTX * 32).float()
    oy = (torch.div(tile, NTX, rounding_mode="floor") * 32).float()
    if opaque:
        # near-opaque, wide Gaussians: most lie along the tile's upper rows
        # and never reach its last rows; 15% cover the whole tile. The
        # upper blocks' pixels saturate first, so the tile goes on only on
        # the lower blocks' flags
        cover = torch.rand(cap, generator=g) < 0.15
        sy = torch.where(cover, torch.tensor(30.0), torch.tensor(6.0))
        fs[0] = ox + torch.rand(cap, generator=g) * 32
        fs[1] = torch.where(cover, oy + 16,
                            oy + 7 + torch.rand(cap, generator=g) * 2)
        fs[2] = 1 / (torch.rand(cap, generator=g) * 2 + 30) ** 2
        fs[3] = 0.0
        fs[4] = 1 / sy ** 2
        fs[5] = torch.log(torch.rand(cap, generator=g) * 0.05 + 0.94)
    else:
        sc = torch.rand(cap, generator=g) * 10 + 1
        fs[0] = torch.rand(cap, generator=g) * WIDTH
        fs[1] = torch.rand(cap, generator=g) * HEIGHT
        fs[2] = 1 / sc ** 2
        fs[3] = 0.2 / sc ** 2
        fs[4] = 1 / sc ** 2
        fs[5] = torch.log(torch.rand(cap, generator=g) * 0.9 + 0.05)
    fs[6:9] = torch.rand((3, cap), generator=g)
    return fs, starts, counts


_PALLAS = {}


def _pallas_fwd(key, fs, starts, counts):
    if key not in _PALLAS:
        f16 = np.concatenate([fs.numpy(),
                              np.zeros((6, fs.shape[1]), np.float32)])
        img, _, _, n_live = rasterize_pallas.rasterize_fwd(
            jnp.asarray(f16), jnp.asarray(starts.numpy()),
            jnp.asarray(counts.numpy()), WIDTH, HEIGHT, interpret=True)
        _PALLAS[key] = (np.asarray(img)[:, :5].reshape(-1, 5, PIX),
                        np.asarray(n_live))
    return _PALLAS[key]
