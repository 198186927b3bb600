"""Resizing at load without PIL (data/scene.resize) against PIL's
Image.resize, which the JAX package's loader calls."""
import numpy as np
import pytest
from PIL import Image

from bilateral_driving_tpu_torch.data import scene as scene_mod

from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("nearest", [False, True])
def test_resize_equals_pil(nearest):
    """uint8 RGB and grey images, shrinking (by 2 as data.downscale=2
    does, and by other factors) and growing, equal to PIL's
    Image.resize to the level (a difference of 0 uint8 levels)."""
    rng = np.random.default_rng(3 + nearest)
    cases = [((64, 96), (32, 48)), ((64, 96), (21, 37)),
             ((17, 23), (40, 29)), ((30, 40), (30, 13)), ((5, 7), (1, 1))]
    for (h0, w0), (h, w) in cases:
        for shape in ((h0, w0, 3), (h0, w0)):
            a = rng.integers(0, 256, shape).astype(np.uint8)
            want = np.asarray(Image.fromarray(a).resize(
                (w, h), Image.NEAREST if nearest else Image.BILINEAR))
            got = scene_mod.resize(a, (w, h), nearest)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
