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
from bilateral_driving_tpu.ops import scan_utils as jscan_utils
from bilateral_driving_tpu_torch.ops import scan_cuda, scan_utils

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


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_scan1d_matches_pallas_kernel(op):
    x = _data(8, np.int32, (COLS + 5,))
    want = np.asarray(scan_pallas.scan1d(jnp.asarray(x), op, interpret=True))
    np.testing.assert_array_equal(
        scan_cuda.scan1d(torch.from_numpy(x), op).numpy(), want)


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


def test_scan_wrapper_raises_instead_of_falling_back():
    before = scan_cuda.scan_rows.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_cuda.scan_rows(torch.zeros((2, 8), dtype=torch.int32,
                                        device="meta"), "sum")
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_utils.cumsum(torch.zeros(8, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        scan_cuda.scan_rows(torch.zeros((2, 8)), "prod")
    scan_utils.cummax(torch.zeros(8, dtype=torch.int32))
    assert scan_cuda.scan_rows.launches == before


@pytest.mark.parametrize("form", ["rows past the old grid limit", "1-D",
                                  "float32 rows", "one element"])
def test_scan_argument_forms_raise_without_cuda(form):
    """Every form the kernel takes raises on a tensor off the CPU when there
    is no card, and counts no launch."""
    x = {"rows past the old grid limit": torch.zeros((70_000, 3),
                                                     dtype=torch.int32),
         "1-D": torch.zeros(5 * scan_cuda.TILE, dtype=torch.int32),
         "float32 rows": torch.zeros((3, 20_000)),
         "one element": torch.zeros(1, dtype=torch.int32)}[form].to("meta")
    before = scan_cuda.scan_rows.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        if x.dim() == 2:
            scan_cuda.scan_rows(x, "max")
        else:
            scan_cuda.scan1d(x, "sum")
    assert scan_cuda.scan_rows.launches == before
