"""The port's segment sums against the Pallas kernels in interpret mode
over 1,024 entries (check_segment_sums in
tests/test_torch_backward_segsum.py, which holds the cases of 2,048: the
parametrized test is split over the two files so that neither holds more
than four tests, README)."""
import pytest

from test_torch_backward_segsum import check_segment_sums
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n,cap,row0,kind", [
    pytest.param(700, 1024, 6, "mixed", id="700-1024-6"),
    pytest.param(33, 1024, 5, "mixed", id="count-not-multiple-of-32"),
    pytest.param(200, 1024, 6, "clamped", id="clamped-offsets")])
def test_segment_sums_match_pallas_kernels(n, cap, row0, kind):
    check_segment_sums(n, cap, row0, kind)
