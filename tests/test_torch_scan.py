"""The port's prefix scan (ops/scan_cuda.py, ops/scan_utils.py) against the
JAX package's Pallas scan kernel and its XLA scans.

On the CPU the port's wrapper runs its plain PyTorch version; the Pallas
kernel runs in interpret mode. The CUDA kernel is held against the plain
version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import scan_pallas
from bilateral_driving_tpu_torch.ops import scan_cuda
from test_torch_threads import one_torch_thread  # noqa: F401

# R not a multiple of 8, M not a multiple of the 8192-lane block
ROWS, COLS = 3, 20000


def _data(seed, dtype, shape):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_scan_rows_matches_pallas_kernel(op, dtype):
    x = _data(7, dtype, (ROWS, COLS))
    want = np.asarray(scan_pallas.scan_rows(jnp.asarray(x), op,
                                            interpret=True))
    got = scan_cuda.scan_rows(torch.from_numpy(x), op).numpy()
    assert got.dtype == x.dtype and got.shape == x.shape
    if op == "sum" and dtype == np.float32:
        # both add the same float32 values in other groupings; each prefix
        # of n terms is within a few n-term rounding errors of the exact
        # sum, well inside 1e-5 of the absolute sum for n <= 20000
        bound = 1e-5 * np.cumsum(np.abs(x.astype(np.float64)), axis=1)
        assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
    else:
        np.testing.assert_array_equal(got, want)
