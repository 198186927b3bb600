"""The port's compositing forward against the Pallas kernel in interpret mode,
and the wrappers' refusals on the CPU (helpers in
tests/test_torch_kernels.py). Split from that file: the port's test files
hold at most four tests each, bar one parametrized test or tests that share
a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import rasterize_pallas
from bilateral_driving_tpu_torch.ops import expand_cuda, rasterize_cuda

from test_torch_kernels import (HEIGHT, NTX, N_TILES, WIDTH, _sorted_feats,
                                _table)
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", [0, 1])
def test_compositing_matches_pallas_kernel(seed):
    fs, starts, counts = _sorted_feats(seed)
    f16 = np.concatenate([fs.numpy(), np.zeros((6, fs.shape[1]), np.float32)])
    img, _, _, n_live = rasterize_pallas.rasterize_fwd(
        jnp.asarray(f16), jnp.asarray(starts.numpy()),
        jnp.asarray(counts.numpy()), WIDTH, HEIGHT, interpret=True)
    want = np.asarray(img)[:, :5].reshape(N_TILES, 5, 1024)
    got = rasterize_cuda.rasterize_fwd(fs, starts, counts, WIDTH, HEIGHT)
    # rgb and alpha at the PARITY.md tolerance; the depth numerator sums
    # depths up to 50, so it is held relative to its size
    rgba = [0, 1, 2, 4]
    np.testing.assert_allclose(got.numpy()[:, rgba], want[:, rgba],
                               atol=3e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[:, 3], want[:, 3], rtol=1e-4,
                               atol=3e-5 * 50)
    # the same per-tile early stop, chunk for chunk
    live = rasterize_cuda.rasterize_fwd_plain(fs, starts, counts, WIDTH,
                                              HEIGHT).n_live
    np.testing.assert_array_equal(live.numpy(), np.asarray(n_live))


def test_wrappers_raise_instead_of_falling_back():
    """A non-CPU tensor takes the kernel path, which needs CUDA: without a
    card the wrappers raise and never run their plain versions."""
    table, offsets, ni = _table(0, 300, 2048, 0.0)
    meta = lambda x: torch.from_numpy(np.asarray(x)).to("meta")
    before = (expand_cuda.expand_gather.launches,
              rasterize_cuda.rasterize_fwd.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        expand_cuda.expand_gather(meta(table), meta(offsets),
                                  meta(np.int32(ni)), 2048, NTX, N_TILES, 300)
    fs, starts, counts = _sorted_feats(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize_cuda.rasterize_fwd(fs.to("meta"), starts.to("meta"),
                                     counts.to("meta"), WIDTH, HEIGHT)
    assert (expand_cuda.expand_gather.launches,
            rasterize_cuda.rasterize_fwd.launches) == before


def test_cpu_path_launches_nothing():
    fs, starts, counts = _sorted_feats(0)
    before = rasterize_cuda.rasterize_fwd.launches
    rasterize_cuda.rasterize_fwd(fs, starts, counts, WIDTH, HEIGHT)
    assert rasterize_cuda.rasterize_fwd.launches == before
