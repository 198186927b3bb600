"""The port's scan at edge lengths against the Pallas kernel in interpret mode
(helpers in tests/test_torch_scan.py). Split from that file: the port's test
files hold at most four tests each, bar one parametrized test or tests that
share a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import scan_pallas
from bilateral_driving_tpu_torch.ops import scan_cuda

from test_torch_scan import _data
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("length", [1, scan_cuda.TILE - 1, scan_cuda.TILE,
                                    scan_cuda.TILE + 1])
def test_scan1d_edge_lengths_match_pallas_kernel(length, op):
    """Lengths around the CUDA kernel's tile, where a row's tail is masked
    and its second tile is the first to look back."""
    x = _data(10, np.int32, (length,))
    want = np.asarray(scan_pallas.scan1d(jnp.asarray(x), op, interpret=True))
    np.testing.assert_array_equal(
        scan_cuda.scan1d(torch.from_numpy(x), op).numpy(), want)
