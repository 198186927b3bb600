"""One step of the pvg and deformablegs presets leaf by leaf and a novel frame
against the JAX package (helpers in tests/test_torch_backgrounds.py). Split
from that file: the port's test files hold at most four tests each, bar one
parametrized test or tests that share a module fixture, so that pytest-
xdist's count-ordered queue (--dist loadfile) runs them after
tests/test_parallel.py (README).
"""
import numpy as np
import pytest

from bilateral_driving_tpu.utils import trajectory as jtrajectory
from test_torch_train import _jax_grads_by_path, _rel

from test_torch_backgrounds import GRAD_RTOL, _step
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=["pvg", "deformablegs"])
def step(request):
    return _step(request.param)


def test_step_matches_jax_leaf_by_leaf(step):
    """Losses within 1e-5; every gradient leaf (taus, log_betas and
    velocity; the Background network's) non-zero and within GRAD_RTOL;
    the density statistics the update accumulates (PVG's |dL/dtau| too)
    against the JAX step's gradients and radii."""
    jg, tg = step["jg"], step["tg"]
    assert set(tg[1]) == set(jg[1])
    for k in jg[1]:
        np.testing.assert_allclose(float(tg[1][k]), float(jg[1][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = _jax_grads_by_path(jg[3])
    got = {k: v.numpy() for k, v in tg[3].items()}
    assert set(got) == set(want)
    extra = ({"Background/taus", "Background/log_betas",
              "Background/velocity"} if step["name"] == "pvg" else
             {"Background/deform_net/trunk.0.weight",
              "Background/deform_net/heads.scale.bias"})
    assert extra <= set(got)
    if step["name"] == "pvg":
        assert {"loss/opacity_entropy", "loss/inverse_depth_smoothness",
                "loss/Background_velocity_reg"} <= set(step["tm"])
    for k in got:
        assert np.any(got[k]), f"zero gradient of {k}"
    rel = {k: _rel(got[k], want[k]) for k in want}
    worst = max(rel, key=rel.get)
    assert rel[worst] < GRAD_RTOL, (worst, rel[worst])
    assert _rel(tg[4].numpy(), np.asarray(jg[4])) < GRAD_RTOL
    st = step["state"].stats["Background"]
    n_bg = st.vis_count.shape[0]
    vis = (np.asarray(jg[2]["info"]["radii"])[:n_bg] > 0).astype(np.float32)
    np.testing.assert_array_equal(st.vis_count.numpy(), vis)
    h, w = step["batch"]["pixels"].shape[:2]
    screen = np.asarray(jg[4])[:n_bg] * np.array([w / 2.0, h / 2.0])
    assert _rel(st.grad_norm.numpy(),
                np.linalg.norm(screen, axis=-1) * vis) < GRAD_RTOL
    if step["name"] == "pvg":
        assert np.any(st.t_grad.numpy())
        assert _rel(st.t_grad.numpy(), np.abs(np.asarray(
            jg[3]["Background"]["taus"])) * vis) < GRAD_RTOL
    assert float(step["tm"]["nonfinite_params"]) == 0
    np.testing.assert_allclose(float(step["tm"]["loss"]), float(jg[0]),
                               rtol=1e-5)


def test_novel_view_frame_matches_jax():
    """A front_center_interp pose (the trajectory within 1e-6 of the JAX
    package's) through trainer.forward(novel_view=True, in_test_set=True),
    the sky from that pose's view directions, against the JAX package's
    forward on the PVG state (compiled with its step)."""
    step = _step("pvg")
    np.testing.assert_allclose(
        step["traj"], jtrajectory.get_novel_trajectory(
            {0: np.asarray(step["jsc"].cameras)}, "front_center_interp", 7),
        atol=1e-6)
    jo, to = step["novel"]
    assert float(np.asarray(jo["opacity"]).mean()) > 0.05
    np.testing.assert_allclose(to["rgb"].numpy(), np.asarray(jo["rgb"]),
                               atol=3e-5)
