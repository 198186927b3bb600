"""The compositing backward's chunk-parallel decomposition against the serial
walk (helpers in tests/test_torch_backward.py). Split from that file: the
port's test files hold at most four tests each, bar one parametrized test or
tests that share a module fixture, so that pytest-xdist's count-ordered
queue (--dist loadfile) runs them after tests/test_parallel.py (README).
"""
import numpy as np
import pytest
import torch

from bilateral_driving_tpu_torch.ops import rasterize_cuda

from test_torch_backward import (HEIGHT, WIDTH, _chunk_parallel_bwd, _rel,
                                 _tile_inputs)
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_parallel_backward_matches_the_serial_walk(seed):
    """The backward kernel runs every live (tile, chunk) pair on its own,
    the pairs tied only by their carries. That decomposition, in PyTorch,
    against rasterize_bwd_plain's walk of each tile's chunks in reverse:
    tiles 0 and 1 and tiles 4 and 5 share a chunk, tile 2 stops early,
    tile 3 has no entries."""
    feats, starts, counts, gout = _tile_inputs(seed)
    tf, ts, tcn = (torch.from_numpy(x) for x in (feats, starts, counts))
    tg = torch.from_numpy(gout)
    _, live, ckpt_off, ckpt = rasterize_cuda.rasterize_fwd(
        tf, ts, tcn, WIDTH, HEIGHT, residuals=True)
    want = rasterize_cuda.rasterize_bwd_plain(tf, ts, tcn, live, ckpt_off,
                                              ckpt, tg, WIDTH, HEIGHT)
    got, pairs = _chunk_parallel_bwd(tf, ts, tcn, live, ckpt_off, ckpt, tg)

    # one pair per live chunk, each in its own slot; the empty tile has none
    # and the chunks shared by two tiles are two pairs each
    assert live[3] == 0 and all(t != 3 for t, _, _ in pairs)
    assert len(pairs) == int(live.sum())
    assert len({slot for _, _, slot in pairs}) == len(pairs)
    assert max(slot for _, _, slot in pairs) < ckpt.shape[0]
    fc = [s // 128 for s in starts]
    for t0, t1 in ((0, 1), (4, 5)):
        shared = [(t, slot) for t, c, slot in pairs if fc[t] + c
                  == (starts[t1]) // 128 and t in (t0, t1)]
        assert len(shared) == 2 and shared[0][1] != shared[1][1]
    # the same entries written, each row within 1e-6 of its norm (measured
    # 1.0e-7 to 1.3e-7 over seeds 0-3): the two form the suffix sums in
    # other orders (the walk takes float32 suffix sums from the chunk's
    # end, the decomposition float64 S less its float64 prefix, as the
    # kernel does)
    np.testing.assert_array_equal((got != 0).numpy(), (want != 0).numpy())
    for r in range(10):
        assert _rel(got[r].numpy(), want[r].numpy()) < 1e-6, r
