"""tools/common.build_synthetic_scene with SMPL pedestrians (and the
DeformableNodes on the rigid instances) against the JAX package's build,
on its scene and its synthetic body carried over (check_build in
tests/test_torch_synthetic.py gives the rules of comparison)."""
import pytest

from test_torch_synthetic import check_build
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("background", ["vanilla", "pvg"])
def test_build_with_smpl_matches_jax(background):
    check_build(background, True)
