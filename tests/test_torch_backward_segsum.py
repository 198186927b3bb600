"""The port's segment sums against the Pallas kernels in interpret mode
(helpers in tests/test_torch_backward.py). Split from that file: the port's
test files hold at most four tests each, bar one parametrized test or tests
that share a module fixture, so that pytest-xdist's count-ordered queue
(--dist loadfile) runs them after tests/test_parallel.py (README).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import segsum_pallas
from bilateral_driving_tpu_torch.ops import segsum_cuda

from test_torch_backward import _segments
from test_torch_threads import one_torch_thread  # noqa: F401


def check_segment_sums(n, cap, row0, kind):
    """segment_sum and segment_sum_rows of n Gaussians' segments over cap
    entries (a multiple of 1,024) against the Pallas kernels."""
    assert cap % 1024 == 0
    offsets = _segments(n, n, cap, kind)
    if kind == "long":
        assert np.diff(offsets).max() > cap // 2
    if kind == "clamped":
        assert offsets[n // 2 + 1] == cap > offsets[n // 2]
    rng = np.random.default_rng(n)
    data = rng.normal(size=(16, cap)).astype(np.float32)
    jo = jnp.asarray(offsets)
    want = np.asarray(segsum_pallas.segment_sum(jnp.asarray(data), jo,
                                                interpret=True))
    got = segsum_cuda.segment_sum(torch.from_numpy(data),
                                  torch.from_numpy(offsets)).numpy()
    # the TPU kernel sums in 3 bf16 limbs (about f32 accuracy)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)

    rows = data[:10]
    want_rows = np.asarray(segsum_pallas.segment_sum_rows(
        tuple(jnp.asarray(r) for r in rows), jo, row0=row0, interpret=True))
    got_rows = segsum_cuda.segment_sum_rows(
        [torch.from_numpy(r) for r in rows], torch.from_numpy(offsets),
        row0=row0).numpy()
    np.testing.assert_allclose(got_rows, want_rows, rtol=3e-5, atol=3e-5)
    assert np.all(got_rows[:row0] == 0) and np.all(got_rows[row0 + 10:] == 0)
    np.testing.assert_array_equal(got_rows[row0:row0 + 10], got[:10])


# the cases of 2,048 entries; those of 1,024 (other compiles of the Pallas
# kernels) are in tests/test_torch_backward_segsum_1024.py
@pytest.mark.parametrize("n,cap,row0,kind", [
    pytest.param(300, 2048, 4, "mixed", id="300-2048-4"),
    pytest.param(100, 2048, 4, "long", id="one-long-segment")])
def test_segment_sums_match_pallas_kernels(n, cap, row0, kind):
    check_segment_sums(n, cap, row0, kind)
