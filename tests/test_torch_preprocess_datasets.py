"""The port's KITTI, PandaSet, Argoverse 2 and nuPlan converters against
the JAX package's (host-side numpy in both), on the raw fixtures of the
JAX package's tests, converted as those tests convert them; every output
file equal (tests/torch_preprocess_trees.py). Then the generic GT
pedestrian tracks of an ego_pose-style scene (KITTI) from both packages'
smpl_track."""
import importlib

import pytest

from test_preprocess_av2_nuplan import (LOG, NUPLAN_LOG,  # noqa: F401
                                       raw_av2, raw_nuplan)
from test_preprocess_kitti import (DRIVE, H, N_FRAMES, W,  # noqa: F401
                                  raw_kitti)
from test_preprocess_pandaset import SEQ, raw_pandaset  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_preprocess_trees import assert_trees_equal, same

# dataset -> (fixture, module, converter, its keyword arguments, scene)
CASES = {
    "kitti": ("raw_kitti", "kitti", "KittiConverter", {}, DRIVE),
    "pandaset": ("raw_pandaset", "pandaset", "PandasetConverter", {}, SEQ),
    "argoverse": ("raw_av2", "argoverse", "ArgoverseConverter", {}, LOG),
    "nuplan": ("raw_nuplan", "nuplan", "NuplanConverter",
               {"start_frame_idx": 0, "max_frames": 10}, NUPLAN_LOG),
}


def _convert(package: str, dataset: str, root: str, target: str) -> str:
    _, module, cls, kw, name = CASES[dataset]
    mod = importlib.import_module(f"{package}.preprocess.{module}")
    return getattr(mod, cls)(root, target, **kw).convert_scene(
        name, out_name="000")


@pytest.mark.parametrize("dataset", sorted(CASES))
def test_converter_matches_jax(dataset, request, tmp_path):
    root = request.getfixturevalue(CASES[dataset][0])
    trees = [_convert(p, dataset, root, str(tmp_path / p))
             for p in ("bilateral_driving_tpu", "bilateral_driving_tpu_torch")]
    assert assert_trees_equal(*trees) > 10


def test_gt_tracks_ego_pose_style(raw_kitti, tmp_path):  # noqa: F811
    from bilateral_driving_tpu.preprocess import smpl_track as jax_st
    from bilateral_driving_tpu_torch.preprocess import smpl_track as port_st

    out = _convert("bilateral_driving_tpu", "kitti", raw_kitti,
                   str(tmp_path / "p"))
    args = (out, [0, 1], {0: (W, H), 1: (W, H)})
    want = jax_st.gt_tracks_from_scene(*args, num_frames=N_FRAMES,
                                       dataset="kitti")
    got = port_st.gt_tracks_from_scene(*args, num_frames=N_FRAMES,
                                       dataset="kitti")
    same(got, want, "gt tracks")
    assert any(f["extra_data"]["gt_track_id"] for f in want[0].values())
