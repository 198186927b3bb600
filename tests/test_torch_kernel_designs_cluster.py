"""The compositing forward's cluster walk modelled on the CPU against the plain
version and the Pallas kernel (helpers in
tests/test_torch_kernel_designs.py). Split from that file: the port's test
files hold at most four tests each, bar one parametrized test or tests that
share a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import numpy as np
import pytest
import torch

from bilateral_driving_tpu_torch.ops import rasterize_cuda

from test_torch_kernel_designs import (HEIGHT, WIDTH, _cluster_fwd,
                                       _fwd_inputs, _pallas_fwd)
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("seed,opaque", [(0, False), (1, True)])
def test_cluster_forward_matches_plain_and_pallas(seed, opaque, k):
    fs, starts, counts = _fwd_inputs(seed, opaque)
    img, n_live, ckpt_off, ckpt, split = _cluster_fwd(fs, starts, counts,
                                                      WIDTH, HEIGHT, k)
    plain = rasterize_cuda.rasterize_fwd_plain(fs, starts, counts, WIDTH,
                                               HEIGHT)
    np.testing.assert_array_equal(n_live.numpy(), plain.n_live.numpy())
    np.testing.assert_array_equal(ckpt_off.numpy(), plain.ckpt_off.numpy())
    rgba = [0, 1, 2, 4]
    for want, depth_rtol in ((plain.img.numpy(), 1e-4),) + (
            (_pallas_fwd((seed, opaque), fs, starts, counts)[0], 1e-4),):
        np.testing.assert_allclose(img.numpy()[:, rgba], want[:, rgba],
                                   atol=3e-5, rtol=0)
        np.testing.assert_allclose(img.numpy()[:, 3], want[:, 3],
                                   rtol=depth_rtol, atol=3e-5 * 50)
    np.testing.assert_array_equal(
        n_live.numpy(), _pallas_fwd((seed, opaque), fs, starts, counts)[1])
    # the live checkpoints: the entry transmittance of each live chunk
    for t in range(starts.shape[0]):
        s = slice(int(ckpt_off[t]), int(ckpt_off[t]) + int(n_live[t]))
        np.testing.assert_allclose(ckpt[s].numpy(), plain.ckpt[s].numpy(),
                                   atol=3e-5, rtol=0)
    if opaque:
        # tiles stop before their last chunk, and some went on after a
        # chunk on the flags of some of their blocks only
        nch = rasterize_cuda._chunk_counts(starts, counts)[3]
        assert bool((n_live < nch).any())
        assert k == 1 or split > 0
    # the same bits whatever the cluster size, and with every entry of the
    # range composited in every row
    ref = _cluster_fwd(fs, starts, counts, WIDTH, HEIGHT, 1, cull=False)
    for a, b in zip((img, n_live, ckpt), (ref[0], ref[1], ref[3])):
        assert torch.equal(a, b)
