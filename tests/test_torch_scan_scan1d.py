"""The port's 1-D scan and scan_utils against the JAX package (helpers in
tests/test_torch_scan.py). Split from that file: the port's test files hold
at most four tests each, bar one parametrized test or tests that share a
module fixture, so that pytest-xdist's count-ordered queue (--dist loadfile)
runs them after tests/test_parallel.py (README).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import scan_pallas
from bilateral_driving_tpu.ops import scan_utils as jscan_utils
from bilateral_driving_tpu_torch.ops import scan_cuda, scan_utils

from test_torch_scan import COLS, _data
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_scan1d_matches_pallas_kernel(op):
    x = _data(8, np.int32, (COLS + 5,))
    want = np.asarray(scan_pallas.scan1d(jnp.asarray(x), op, interpret=True))
    np.testing.assert_array_equal(
        scan_cuda.scan1d(torch.from_numpy(x), op).numpy(), want)


def test_scan_utils_match_jax_scan_utils_on_int32():
    """Bit-equal on int32, including sums that wrap past 2^31 like the
    binning offsets of an overflowing frame would."""
    rng = np.random.default_rng(9)
    small = rng.integers(0, 50, 100_003).astype(np.int32)
    big = rng.integers(2 ** 28, 2 ** 30, 4099).astype(np.int32)
    for x in (small, big):
        t = torch.from_numpy(x)
        for mine, theirs in ((scan_utils.cumsum, jscan_utils.cumsum),
                             (scan_utils.cummax, jscan_utils.cummax),
                             (scan_utils.cummin, jscan_utils.cummin)):
            got = mine(t)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(theirs(jnp.asarray(x))))
