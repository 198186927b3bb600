"""The port's two kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode, as tests/test_expand_pallas.py runs them.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import expand_pallas
from bilateral_driving_tpu_torch.ops import binning, expand_cuda
from test_torch_threads import one_torch_thread  # noqa: F401

WIDTH, HEIGHT = 96, 64
NTX, NTY = binning.num_tiles(WIDTH, HEIGHT)
N_TILES = NTX * NTY


def _table(seed, n, cap, zero_frac):
    """Per-Gaussian table + offsets like the pipeline builds them, dense
    enough for the TPU kernel's window contract."""
    rng = np.random.default_rng(seed)
    tx0 = rng.integers(0, NTX, n)
    ty0 = rng.integers(0, NTY, n)
    sw = np.minimum(rng.integers(1, 4, n), NTX - tx0)
    sh = np.minimum(rng.integers(1, 4, n), NTY - ty0)
    counts = (sw * sh).astype(np.int32)
    counts[rng.random(n) < zero_frac] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    num_isects = int(offsets[-1])
    offsets = np.minimum(offsets, cap)
    feats = rng.normal(size=(10, n)).astype(np.float32)
    feats[9] = rng.uniform(0.5, 50.0, n)
    table = np.concatenate([
        np.stack([tx0, ty0, sw, offsets[:-1]]).astype(np.float32), feats,
        np.stack([np.arange(n), np.zeros(n)]).astype(np.float32)])
    return table, offsets, num_isects


@pytest.mark.parametrize("zero_frac,cap", [(0.0, 2048), (0.3, 2048),
                                           (0.0, 128)])
def test_expand_matches_pallas_kernel_exactly(zero_frac, cap):
    table, offsets, ni = _table(0, 300, cap, zero_frac)
    k1, g1, f1 = expand_pallas.expand_gather(
        jnp.asarray(table), jnp.asarray(offsets), jnp.int32(ni), cap, NTX,
        N_TILES, 300, interpret=True)
    k2, g2, f2 = expand_cuda.expand_gather(
        torch.from_numpy(table), torch.from_numpy(offsets),
        torch.tensor(ni, dtype=torch.int32), cap, NTX, N_TILES, 300)
    np.testing.assert_array_equal(np.asarray(k1), k2.numpy())
    np.testing.assert_array_equal(np.asarray(g1), g2.numpy())
    np.testing.assert_array_equal(np.asarray(f1).view(np.int32),
                                  f2.numpy().view(np.int32))


def test_expand_matches_xla_formulation_on_sparse_tables():
    """Many zero-count rows between live ones (capacity padding of the
    scene classes): the port equals expand_gather_xla bit for bit."""
    cap = 2048
    table, offsets, ni = _table(1, 2000, cap, 0.9)
    block, lw = expand_pallas._block_lw(cap)
    k1, g1, f1 = expand_pallas.expand_gather_xla(
        expand_pallas.pad_table(jnp.asarray(table), lw), jnp.asarray(offsets),
        jnp.int32(ni), cap, NTX, N_TILES, 2000)
    k2, g2, f2 = expand_cuda.expand_gather(
        torch.from_numpy(table), torch.from_numpy(offsets),
        torch.tensor(ni, dtype=torch.int32), cap, NTX, N_TILES, 2000)
    np.testing.assert_array_equal(np.asarray(k1), k2.numpy())
    np.testing.assert_array_equal(np.asarray(g1), g2.numpy())
    np.testing.assert_array_equal(np.asarray(f1).view(np.int32),
                                  f2.numpy().view(np.int32))


def _sorted_feats(seed, cap=2048):
    """Sorted per-entry features and tile ranges at realistic magnitudes."""
    table, offsets, ni = _table(seed, 300, cap, 0.2)
    key, _, feats = expand_cuda.expand_gather(
        torch.from_numpy(table), torch.from_numpy(offsets),
        torch.tensor(ni, dtype=torch.int32), cap, NTX, N_TILES, 300)
    key_s, perm = torch.sort(key, stable=True)
    starts, counts = binning.tile_ranges(
        binning.tiles_of_keys(key_s, N_TILES),
        torch.tensor(ni, dtype=torch.int32), N_TILES, cap)
    g = torch.Generator().manual_seed(seed)
    sc = torch.rand(cap, generator=g) * 10 + 1
    fs = feats[:, perm].clone()
    fs[0] = torch.rand(cap, generator=g) * WIDTH
    fs[1] = torch.rand(cap, generator=g) * HEIGHT
    fs[2] = 1 / sc ** 2
    fs[3] = 0.2 / sc ** 2
    fs[4] = 1 / sc ** 2
    fs[5] = torch.log(torch.rand(cap, generator=g) * 0.9 + 0.05)
    fs[6:9] = torch.rand((3, cap), generator=g)
    return fs, starts, counts
