"""The scan wrapper's refusals and argument forms on the CPU (helpers in
tests/test_torch_scan.py). Split from that file: the port's test files hold
at most four tests each, bar one parametrized test or tests that share a
module fixture, so that pytest-xdist's count-ordered queue (--dist loadfile)
runs them after tests/test_parallel.py (README).
"""
import pytest
import torch

from bilateral_driving_tpu_torch.ops import scan_cuda, scan_utils

from test_torch_threads import one_torch_thread  # noqa: F401


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
