"""The port's PNG writer against PIL's decoder (helpers in
tests/test_torch_render_cli.py). Split from that file: the port's test files
hold at most four tests each, bar one parametrized test or tests that share
a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import numpy as np
import pytest

from PIL import Image
from bilateral_driving_tpu.utils import visualization as jvis
from bilateral_driving_tpu_torch.utils import visualization

from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape", [(7, 5, 3), (6, 9), (4, 3, 4)])
def test_save_png_decodes_as_pil_writes(tmp_path, shape):
    """The port's PNG, decoded by PIL, holds the bytes of the JAX
    package's PIL-written PNG of the same float image."""
    img = np.random.default_rng(3).uniform(-0.2, 1.2, shape).astype(
        np.float32)
    ours, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    visualization.save_png(img, ours)
    jvis.save_png(img, theirs)
    a, b = np.asarray(Image.open(ours)), np.asarray(Image.open(theirs))
    assert a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
