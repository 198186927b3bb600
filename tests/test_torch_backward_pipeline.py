"""The port's rasterize pipeline gradients against the JAX package's (helpers
in tests/test_torch_backward.py). Split from that file: the port's test
files hold at most four tests each, bar one parametrized test or tests that
share a module fixture, so that pytest-xdist's count-ordered queue (--dist
loadfile) runs them after tests/test_parallel.py (README).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import pipeline as jpipeline
from bilateral_driving_tpu_torch.ops import pipeline

from test_torch_backward import HEIGHT, WIDTH, _gaussians, _rel
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_gradients_match_jax(seed):
    """torch.autograd.grad of the port's rasterize against jax.vjp of the
    JAX rasterize (XLA expansion; its Pallas expansion mis-handles sparse
    tables, ROADMAP.md) with the same cotangents on rgb, depth and alpha,
    and the screen-space gradient of means2d_dummy."""
    inputs, cot = _gaussians(seed)
    n = inputs[0].shape[0]
    jcfg = jpipeline.RasterizeConfig(isect_capacity=2 ** 13, interpret=True,
                                     pallas_expand=False)

    def jf(means, quats, scales, opac, colors, dummy):
        out = jpipeline.rasterize(means, quats, scales, opac, colors,
                                  jnp.asarray(inputs[5]),
                                  jnp.asarray(inputs[6]), WIDTH, HEIGHT,
                                  jcfg, means2d_dummy=dummy)
        return out["rgb"], out["depth"], out["alpha"]

    @jax.jit
    def forward_and_vjp(*args):
        out, vjp = jax.vjp(jf, *args)
        return out, vjp(tuple(jnp.asarray(c) for c in cot))

    jout, want = forward_and_vjp(*[jnp.asarray(x) for x in inputs[:5]],
                                 jnp.zeros((n, 2)))

    tin = [torch.from_numpy(x).requires_grad_(True) for x in inputs[:5]]
    dummy = torch.zeros((n, 2), requires_grad=True)
    out = pipeline.rasterize(*tin, torch.from_numpy(inputs[5]),
                             torch.from_numpy(inputs[6]), WIDTH, HEIGHT,
                             pipeline.RasterizeConfig(isect_capacity=2 ** 13),
                             means2d_dummy=dummy)
    assert float(out["alpha"].detach().mean()) > 0.2
    for k, j in zip(("rgb", "depth", "alpha"), jout):
        hit = np.asarray(jout[2]) > 0.2 if k == "depth" else Ellipsis
        np.testing.assert_allclose(out[k].detach().numpy()[hit],
                                   np.asarray(j)[hit], atol=1e-3 if
                                   k == "depth" else 3e-5, rtol=1e-4)
    got = torch.autograd.grad(
        [out["rgb"], out["depth"], out["alpha"]], tin + [dummy],
        [torch.from_numpy(c) for c in cot])
    # 1e-4 relative norm per input. Both sides composite the same entries,
    # but the JAX forward forms sigma from pixel monomials and its backward
    # chains through pixel moments, so every transmittance and each conic
    # gradient rounds differently: measured 1.2e-5 (colors) to 6.2e-5
    # (scales) over seeds 0-2. The JAX package's own 1e-5 (Pallas against
    # its XLA path) compares two backwards of one forward.
    for name, a, b in zip(("means", "quats", "scales", "opacities", "colors",
                           "means2d"), got, want):
        assert _rel(a.numpy(), b) < 1e-4, (name, _rel(a.numpy(), b))
