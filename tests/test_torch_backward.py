"""The port's backward kernel modules against the JAX package's Pallas
kernels: compositing backward, ragged segment sums, the cube-map splat, and
the pipeline's gradients as a whole.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode, as the JAX package's own tests run them. The
CUDA kernels are held against these plain versions on the card by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import rasterize_pallas
from bilateral_driving_tpu_torch.ops import (binning, cubemap_cuda, pipeline,
                                             rasterize_cuda, segsum_cuda)
from test_torch_threads import one_torch_thread  # noqa: F401

WIDTH, HEIGHT = 96, 64
NTX, NTY = binning.num_tiles(WIDTH, HEIGHT)
N_TILES = NTX * NTY
CAP = 2048
# tile ranges: tiles 0 and 1 share the 128-entry chunk 1, tile 2 is dense
# and opaque enough to stop early, tile 3 is empty, tiles 4 and 5 share
# chunk 8
RANGES = [(0, 200), (200, 330), (330, 1100), (1100, 1100), (1100, 1150),
          (1150, 1400)]


def _rel(a, b):
    """Relative norm of the difference."""
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _tile_inputs(seed):
    """Sorted per-entry features over RANGES, the features of each entry
    placed around its own tile."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((10, CAP), np.float32)
    feats[5] = -30.0
    starts = np.array([s for s, _ in RANGES], np.int32)
    counts = np.array([e - s for s, e in RANGES], np.int32)
    for t, (s, e) in enumerate(RANGES):
        n = e - s
        ox, oy = (t % NTX) * 32, (t // NTX) * 32
        sc = rng.uniform(1.5, 8.0, n) * (3.0 if t == 2 else 1.0)
        feats[0, s:e] = ox + rng.uniform(-4, 36, n)
        feats[1, s:e] = oy + rng.uniform(-4, 36, n)
        feats[2, s:e] = 1 / sc ** 2
        feats[3, s:e] = rng.uniform(-0.3, 0.3, n) / sc ** 2
        feats[4, s:e] = 1 / sc ** 2
        feats[5, s:e] = np.log(rng.uniform(0.9, 0.999, n) if t == 2
                               else rng.uniform(0.05, 0.95, n))
        feats[6:9, s:e] = rng.uniform(0, 1, (3, n))
        feats[9, s:e] = np.sort(rng.uniform(1, 50, n))
    gout = rng.normal(size=(N_TILES, 5, 1024)).astype(np.float32)
    return feats, starts, counts, gout


@pytest.mark.parametrize("seed", [0, 1])
def test_compositing_backward_matches_pallas_kernel(seed):
    feats, starts, counts, gout = _tile_inputs(seed)
    f16 = jnp.asarray(np.concatenate([feats, np.zeros((6, CAP), np.float32)]))
    js, jc = jnp.asarray(starts), jnp.asarray(counts)
    _, tc_ckpt, tc_side, n_live = rasterize_pallas.rasterize_fwd(
        f16, js, jc, WIDTH, HEIGHT, interpret=True)
    g8 = np.zeros((N_TILES, 8, 1024), np.float32)
    g8[:, :5] = gout
    want = np.asarray(rasterize_pallas.rasterize_bwd(
        f16, js, jc, n_live, tc_ckpt, tc_side,
        jnp.asarray(g8.reshape(N_TILES, 8, 8, 128)), WIDTH, HEIGHT,
        interpret=True))[:10]

    tf = torch.from_numpy(feats)
    ts, tcn = torch.from_numpy(starts), torch.from_numpy(counts)
    img, live, ckpt_off, ckpt = rasterize_cuda.rasterize_fwd(
        tf, ts, tcn, WIDTH, HEIGHT, residuals=True)
    np.testing.assert_array_equal(live.numpy(), np.asarray(n_live))
    # the opaque tile stops before its last chunk, the others do not
    assert live[2] < (1100 + 127) // 128 - 330 // 128
    assert ckpt.shape[0] == CAP // 128 + N_TILES
    got = rasterize_cuda.rasterize_bwd(tf, ts, tcn, live, ckpt_off, ckpt,
                                       torch.from_numpy(gout), WIDTH,
                                       HEIGHT).numpy()
    # entries past a tile's stop, and outside every range, get exactly 0
    stopped = np.arange(330 // 128 * 128 + int(live[2]) * 128, 1100)
    assert np.all(got[:, stopped] == 0) and np.all(want[:, stopped] == 0)
    assert np.all(got[:, 1400:] == 0)
    # each gradient row within 1e-4 of its norm. The two sum the same terms
    # in other orders and forms: the TPU kernel chains sigma through pixel
    # moments (sum p^2 dsigma - 2 m sum p dsigma + m^2 sum dsigma), which
    # cancels; against a float64 evaluation of the same sweep its rows
    # differ by up to 4e-5 on these inputs, and a few pairs at the 0.999
    # clamp and the 1/255 gate round to the other side
    for r in range(10):
        assert _rel(got[r], want[r]) < 1e-4, r
    assert np.abs(got).max() > 0


def _chunk_parallel_bwd(feats, starts, counts, n_live, ckpt_off, ckpt,
                        gout):
    """csrc/rasterize_bwd.cu's decomposition in PyTorch: the live (tile,
    chunk) pairs listed tile by tile (its items pass); each pair's chunk
    sum S of w G per pixel in float64 at slot ckpt_off[tile] + chunk (sums);
    each slot's carry, the float32 sum of float32(S) over the tile's later
    live chunks added last chunk first (carry); each pair's gradients from
    its own S, carry and checkpoint alone (grads). Returns the gradients
    and the pairs' (tile, chunk, slot)."""
    tl = rasterize_cuda._tiling(starts, counts, WIDTH, HEIGHT)
    nl = n_live.long()
    tiles = torch.repeat_interleave(torch.arange(N_TILES), nl)
    chunks = torch.arange(tiles.numel()) - (torch.cumsum(nl, 0) - nl)[tiles]
    slots = ckpt_off.long()[tiles] + chunks
    pairs = list(zip(tiles.tolist(), chunks.tolist(), slots.tolist()))

    def sweep(t, c, slot):
        gidx, f, inm, dx, dy, alpha = rasterize_cuda._chunk_alpha(
            feats, tl, torch.tensor([t]), c)
        t_excl, _ = rasterize_cuda._exclusive_transmittance(alpha)
        trans = (t_excl * ckpt[slot])[0]                   # (CHUNK, PIX)
        f = f[:, 0]                                        # (10, CHUNK, 1)
        G = (torch.einsum("ck,cp->kp", f[6:10, :, 0], gout[t, :4])
             + gout[t, 4])
        w = alpha[0] * trans
        return gidx[0], f, inm[0], dx[0], dy[0], alpha[0], trans, G, w

    sums = {}
    for t, c, slot in pairs:
        *_, G, w = sweep(t, c, slot)
        sums[slot] = (w * G).double().sum(0)
    carry = {}
    for t in range(N_TILES):
        cr = torch.zeros(rasterize_cuda.PIX)
        for c in range(int(nl[t]) - 1, -1, -1):
            slot = int(ckpt_off[t]) + c
            carry[slot] = cr
            cr = cr + sums[slot].float()
    dfeats = torch.zeros((10, feats.shape[1]))
    for t, c, slot in pairs:
        gidx, f, inm, dx, dy, alpha, trans, G, w = sweep(t, c, slot)
        prefix = torch.cumsum((w * G).double(), 0)
        suffix = (sums[slot] - prefix).float() + carry[slot]
        one_m = torch.clamp(1.0 - alpha, min=1.0 - rasterize_cuda.MAX_ALPHA)
        d_alpha = trans * G - suffix / one_m
        gate = (alpha > 0.0) & (alpha < rasterize_cuda.MAX_ALPHA)
        ds = torch.where(gate, -(alpha * d_alpha), torch.zeros(()))
        a, b, cq = f[2], f[3], f[4]
        d = torch.where(gate, torch.stack([
            -(ds * (a * dx + b * dy)), -(ds * (cq * dy + b * dx)),
            ds * (0.5 * dx * dx), ds * (dx * dy), ds * (0.5 * dy * dy), -ds,
        ]), torch.zeros(())).sum(-1)
        d = torch.cat([d, torch.einsum("cp,kp->ck", gout[t, :4], w)])
        dfeats[:, gidx[inm]] = d[:, inm]
    return dfeats, pairs


def _segments(seed, n, cap, kind="mixed"):
    """Offsets with empty, short and a few long segments, clamped to cap
    like an overflowing frame's. "long": one Gaussian owns most of cap;
    "clamped": a segment crosses cap and every later one is empty there."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, n)
    counts[rng.random(n) < 0.3] = 0
    if kind == "long":
        counts[n // 3] = cap - int(counts.sum()) - 17
    else:
        counts[rng.integers(0, n, 3)] = rng.integers(100, 400, 3)
    if kind == "clamped":
        counts[n // 2] = cap
    offsets = np.minimum(np.concatenate([[0], np.cumsum(counts)]), cap)
    return offsets.astype(np.int32)


def _smooth_dirs(h, w):
    xs = np.linspace(-0.4, 0.4, w)
    ys = np.linspace(-0.3, 0.3, h)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx, gy, np.ones_like(gx)], -1).astype(np.float32)


def _gaussians(seed, n=300):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n),
                      rng.uniform(4, 25, n)], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-2.5, -0.5, (n, 3))).astype(np.float32)
    opac = rng.uniform(0.1, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    K = np.array([[80.0, 0, WIDTH / 2], [0, 80.0, HEIGHT / 2], [0, 0, 1]],
                 np.float32)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((HEIGHT, WIDTH, 3), (HEIGHT, WIDTH, 1),
                     (HEIGHT, WIDTH, 1))]
    return (means, quats, scales, opac, colors, view, K), cot


def test_render_path_saves_no_residuals():
    """Without grad mode the forward writes no checkpoints: the same call
    under no_grad returns tensors without a graph."""
    inputs, _ = _gaussians(0)
    tin = [torch.from_numpy(x).requires_grad_(True) for x in inputs[:5]]
    with torch.no_grad():
        out = pipeline.rasterize(*tin, torch.from_numpy(inputs[5]),
                                 torch.from_numpy(inputs[6]), WIDTH, HEIGHT,
                                 pipeline.RasterizeConfig(
                                     isect_capacity=2 ** 13))
    assert out["rgb"].grad_fn is None


def test_backward_wrappers_raise_instead_of_falling_back():
    feats, starts, counts, gout = _tile_inputs(0)
    meta = lambda x: torch.from_numpy(np.asarray(x)).to("meta")
    before = (rasterize_cuda.rasterize_bwd.launches,
              segsum_cuda.segment_sum.launches,
              segsum_cuda.segment_sum_rows.launches,
              cubemap_cuda.splat_grad.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize_cuda.rasterize_bwd(
            meta(feats), meta(starts), meta(counts), meta(counts),
            meta(starts), meta(np.zeros((4, 1024), np.float32)), meta(gout),
            WIDTH, HEIGHT)
    offsets = meta(_segments(0, 10, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        segsum_cuda.segment_sum(meta(feats[:, :64]), offsets)
    with pytest.raises(RuntimeError, match="CUDA"):
        segsum_cuda.segment_sum_rows([meta(feats[0, :64])], offsets, row0=4)
    idx = meta(np.zeros(8, np.int32))
    w = meta(np.zeros(8, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        cubemap_cuda.splat_grad(idx, idx, idx, w, w,
                           meta(np.zeros((8, 3), np.float32)), 16)
    assert before == (rasterize_cuda.rasterize_bwd.launches,
                      segsum_cuda.segment_sum.launches,
                      segsum_cuda.segment_sum_rows.launches,
                      cubemap_cuda.splat_grad.launches)
