"""The port's neural bilateral grid against the JAX package (helpers in
tests/test_torch_appearance.py). Split from that file: the port's test files
hold at most four tests each, bar one parametrized test or tests that share
a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu_torch.models import bilateral

from test_torch_appearance import (NEIGHBOURS, N_IMAGES, _drawn, _images,
                                   _parity, _shapes)
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("nbrs", NEIGHBOURS, ids=["image", "neighbours"])
def test_neural_bilateral_matches_jax(nbrs):
    tree = _drawn(_shapes(jbilateral.init_neural_bilateral, N_IMAGES, 8, 6,
                          4, 8, 16), 11)
    jn = None if nbrs is None else jnp.asarray(nbrs)
    _parity(lambda p, rgb: jbilateral.neural_bilateral_affines(
        p, rgb, 1, neighbor_idx=jn),
        lambda p, rgb: bilateral.neural_bilateral_affines(
            p, rgb, 1, neighbor_idx=nbrs), tree, _images(12))


def test_neural_bilateral_tv_matches_jax():
    tree = {"grids": np.random.default_rng(13).normal(
        0, 0.3, (N_IMAGES, 8, 4, 6, 8)).astype(np.float32)}
    _parity(jbilateral.bilateral_tv_loss, bilateral.bilateral_tv_loss, tree)


def test_neural_inits_match_jax():
    g = torch.Generator().manual_seed(0)
    p = bilateral.init_neural_bilateral(g, N_IMAGES, 8, 6, 4, 8, 16,
                                        device="cpu")
    jp = _shapes(jbilateral.init_neural_bilateral, N_IMAGES, 8, 6, 4, 8, 16)
    assert p["grids"].shape == jp["grids"].shape and not p["grids"].any()
    ms = bilateral.init_multiscale_neural(g, N_IMAGES, device="cpu")
    jms = _shapes(jbilateral.init_multiscale_neural, N_IMAGES)
    for head, jhead in [(p["head"], jp["head"])] + [
            (a["head"], b["head"]) for a, b in zip(ms["levels"],
                                                   jms["levels"])]:
        assert [tuple(layer["w"].shape) for layer in head["layers"]] == [
            layer["w"].shape for layer in jhead["layers"]]
        assert head["layers"][0]["w"].any()
        assert not head["layers"][-1]["w"].any()
    for a, b in zip(ms["levels"], jms["levels"], strict=True):
        assert a["grids"].shape == b["grids"].shape
