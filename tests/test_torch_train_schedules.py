"""The port's learning-rate schedules against the JAX package (helpers in
tests/test_torch_train.py). Split from that file: the port's test files hold
at most four tests each, bar one parametrized test or tests that share a
module fixture, so that pytest-xdist's count-ordered queue (--dist loadfile)
runs them after tests/test_parallel.py (README).
"""
import numpy as np
import pytest

from bilateral_driving_tpu.train import schedules as jschedules
from bilateral_driving_tpu_torch.train import schedules

from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("warmup,final", [(0, None), (1000, 3e-5), (0, 1e-6)])
def test_schedule_matches_jax(warmup, final):
    kw = dict(lr_init=6e-4, lr_final=final, warmup_steps=warmup,
              max_steps=30000, lr_pre_warmup=0.0)
    tf = schedules.make_schedule(schedules.LRConfig(**kw))
    jf = jschedules.make_schedule(jschedules.LRConfig(**kw))
    for step in (0, 1, 500, 999, 1000, 1001, 15000, 29999, 30000, 40000):
        np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6,
                                   atol=0, err_msg=str(step))
