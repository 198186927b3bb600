"""The expansion's warp search and the compositing forward's row test modelled
on the CPU (helpers in tests/test_torch_kernel_designs.py). Split from that
file: the port's test files hold at most four tests each, bar one
parametrized test or tests that share a module fixture, so that pytest-
xdist's count-ordered queue (--dist loadfile) runs them after
tests/test_parallel.py (README).
"""
import numpy as np
import torch

from bilateral_driving_tpu_torch.ops import binning, rasterize_cuda

from test_torch_kernel_designs import (HEIGHT, PIX, WIDTH, _chip_smoke,
                                       _fwd_inputs, _may_reach,
                                       _random_entries, _span_table,
                                       _warp_owner)
from test_torch_threads import one_torch_thread  # noqa: F401


def test_warp_owner_search_steps():
    """The 32-pivot search finds the owner of every entry of a sparse
    table, in at most ceil(log32(n)) + 1 steps."""
    table, offsets, ni = _span_table(7, 5000, 3, 2, 0.7, 3, 1 << 20)
    fill = binning.fill_monotone(torch.arange(5000, dtype=torch.int32),
                                 torch.from_numpy(offsets[:-1]), ni).numpy()
    for m in range(0, ni, 7):
        assert _warp_owner(offsets, 5000, m) == fill[m]


def test_row_cull_drops_only_entries_the_gate_drops():
    """Wherever _may_reach says an entry cannot reach a row, the kernel's
    f32 alpha is below the gate at all 32 pixels of the row; and it says
    so for most far entries, near the edge of the gate too."""
    rng = np.random.default_rng(0)
    n = 200_000
    f32 = np.float32
    mx, my, ha, b, hc, lg = _random_entries(rng, n)
    py = f32(rng.integers(0, 32) + 0.5)
    reach = _may_reach(mx, my, ha, b, hc, lg, py)
    px = np.arange(32, dtype=f32) + f32(0.5)
    with np.errstate(all="ignore"):
        dx = px[None, :] - mx[:, None]
        dy = (py - my)[:, None]
        sigma = (ha[:, None] * dx * dx + hc[:, None] * dy * dy
                 + b[:, None] * dx * dy - lg[:, None])
        e = np.exp(-sigma)
    alpha = np.where(e > f32(0.999), f32(0.999), e)
    passes = (alpha >= f32(1.0 / 255.0)).any(1)
    assert not (passes & ~reach).any()
    assert (~reach).sum() > n // 4
    # at the gate's edge: a Gaussian centred on the row, its least sigma
    # -logop, is dropped from the row just above ln(255) + margin and kept
    # at ln(255)
    assert not bool(_may_reach(16.5, 16.5, 0.5, 0.0, 0.5, -5.56, 16.5))
    assert bool(_may_reach(16.5, 16.5, 0.5, 0.0, 0.5, -5.5413, 16.5))


def test_bound_counts_the_kernels_row_test():
    """chip_smoke.py's compositing bound leaves out the rows the kernel's
    row test leaves out: its torch row test is _may_reach at all 32 rows,
    and its counts lie between the blended pairs and every live pair."""
    cs = _chip_smoke()
    entries = _random_entries(np.random.default_rng(1), 50_000)
    got = cs.may_reach_rows(*(torch.from_numpy(x) for x in entries))
    want = np.stack([_may_reach(*entries, r + 0.5) for r in range(32)], -1)
    np.testing.assert_array_equal(got.numpy(), want)
    fs, starts, counts = _fwd_inputs(0, False)
    plain = rasterize_cuda.rasterize_fwd_plain(fs, starts, counts, WIDTH,
                                               HEIGHT)
    blend = int(plain.n_blend)
    work = cs.compositing_work(fs, starts, counts, plain.n_live, WIDTH,
                               blend, cs.ENTRY_OPS, cs.BLEND_OPS)
    n = work["live_entries"]
    assert n == int(cs.tile_live_entries(starts, counts, plain.n_live).sum())
    assert 0 < blend <= work["reach_pairs"] < work["live_pairs"] == n * PIX
    assert work["ops"] == (n * (cs.ENTRY_OPS + 32 * cs.ROW_OPS)
                           + work["reach_pairs"] * cs.PAIR_OPS
                           + blend * cs.BLEND_OPS)
