"""The segment-sum wrapper's argument forms on the CPU (helpers in
tests/test_torch_backward.py). Split from that file: the port's test files
hold at most four tests each, bar one parametrized test or tests that share
a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import pytest
import torch

from bilateral_driving_tpu_torch.ops import segsum_cuda

from test_torch_backward import _segments
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("form,n_rows,row0", [
    ("stacked", 1, 0), ("stacked", 16, 0), ("split", 1, 15),
    ("split", 16, 0), ("split", 10, 6)])
def test_segment_sum_argument_forms_raise_without_cuda(form, n_rows, row0):
    """The stacked input (one base pointer and a row stride) and the split
    one (a pointer per row, landing at row0) raise on tensors off the CPU
    when there is no card, and count no launch."""
    data = torch.zeros((n_rows, 1024)).to("meta")
    offsets = torch.from_numpy(_segments(0, 100, 1024)).to("meta")
    before = (segsum_cuda.segment_sum.launches,
              segsum_cuda.segment_sum_rows.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        if form == "stacked":
            segsum_cuda.segment_sum(data, offsets)
        else:
            segsum_cuda.segment_sum_rows(list(data), offsets, row0=row0)
    assert before == (segsum_cuda.segment_sum.launches,
                      segsum_cuda.segment_sum_rows.launches)
