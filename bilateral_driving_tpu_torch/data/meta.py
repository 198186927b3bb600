"""Per-dataset camera metadata and on-disk calibration layouts: the port's
copy of bilateral_driving_tpu/data/meta.py (numpy only).

Counterpart of the reference's `project/datasets/dataset_meta.py` (camera
names, original sizes, egocar visibility) plus the layout facts that the six
per-dataset sourceloaders hard-code:

  * calibration style (`nuscenes_sourceloader.py:76-113` stores per-frame
    `extrinsics/{t:03d}_{cam}.txt` cam-to-world; `waymo_sourceloader.py:74-99`
    stores static `extrinsics/{cam}.txt` cam-to-ego plus per-frame
    `ego_pose/{t:03d}.txt`);
  * the dataset->OpenCV axis permutation (`OPENCV2DATASET`; identity for all
    datasets except Waymo's x-front/y-left/z-up frame,
    `waymo_sourceloader.py:31-33`);
  * lidar record format (`nuscenes_sourceloader.py:393` float32 (N,4) xyzi in
    the lidar frame with `lidar_pose/{t:03d}.txt`; `waymo_sourceloader.py:391-399`
    float32 (N,14) rows [origin(3) point(3) flow(3) flow_class ground
    intensity elongation laser_id] already in the ego frame);
  * which pose the world is recentered on (first front cam vs first ego pose).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraMeta:
    name: str
    original_size: Tuple[int, int]        # (H, W)
    egocar_visible: bool = False


@dataclasses.dataclass(frozen=True)
class DatasetLayout:
    name: str
    cameras: Dict[int, CameraMeta]
    # "per_frame": extrinsics/{t:03d}_{cam}.txt is cam-to-world per frame
    # "ego_pose": extrinsics/{cam}.txt is cam-to-ego; ego_pose/{t:03d}.txt
    #             is ego-to-world per frame
    calib_style: str = "per_frame"
    # dataset camera axes -> OpenCV (x right, y down, z front)
    opencv2dataset: Optional[np.ndarray] = None
    lidar_format: str = "xyzi"            # "xyzi" | "waymo14"
    # world frame recentering anchor: "front_cam" | "ego"
    world_anchor: str = "front_cam"

    def opencv_mat(self) -> np.ndarray:
        if self.opencv2dataset is None:
            return np.eye(4)
        return self.opencv2dataset


_WAYMO_OPENCV = np.array(
    [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float64)


DATASETS: Dict[str, DatasetLayout] = {
    "waymo": DatasetLayout(
        name="waymo",
        cameras={
            0: CameraMeta("front_camera", (1280, 1920)),
            1: CameraMeta("front_left_camera", (1280, 1920)),
            2: CameraMeta("front_right_camera", (1280, 1920)),
            3: CameraMeta("left_camera", (866, 1920)),
            4: CameraMeta("right_camera", (866, 1920)),
        },
        calib_style="ego_pose",
        opencv2dataset=_WAYMO_OPENCV,
        lidar_format="waymo14",
        world_anchor="ego",
    ),
    "pandaset": DatasetLayout(
        name="pandaset",
        cameras={
            0: CameraMeta("front_camera", (1080, 1920)),
            1: CameraMeta("front_left_camera", (1080, 1920)),
            2: CameraMeta("front_right_camera", (1080, 1920)),
            3: CameraMeta("left_camera", (1080, 1920)),
            4: CameraMeta("right_camera", (1080, 1920)),
            5: CameraMeta("back_camera", (1080, 1920), egocar_visible=True),
        },
        calib_style="per_frame",
        lidar_format="xyzil",
        world_anchor="ego",
    ),
    "argoverse": DatasetLayout(
        name="argoverse",
        cameras={
            0: CameraMeta("ring_front_center", (2048, 1550),
                          egocar_visible=True),
            1: CameraMeta("ring_front_left", (1550, 2048)),
            2: CameraMeta("ring_front_right", (1550, 2048)),
            3: CameraMeta("ring_side_left", (1550, 2048)),
            4: CameraMeta("ring_side_right", (1550, 2048)),
            5: CameraMeta("ring_rear_left", (1550, 2048), egocar_visible=True),
            6: CameraMeta("ring_rear_right", (1550, 2048),
                          egocar_visible=True),
        },
        calib_style="ego_pose",
        world_anchor="ego",
    ),
    "nuscenes": DatasetLayout(
        name="nuscenes",
        cameras={
            0: CameraMeta("CAM_FRONT", (900, 1600)),
            1: CameraMeta("CAM_FRONT_LEFT", (900, 1600)),
            2: CameraMeta("CAM_FRONT_RIGHT", (900, 1600)),
            3: CameraMeta("CAM_BACK_LEFT", (900, 1600)),
            4: CameraMeta("CAM_BACK_RIGHT", (900, 1600)),
            5: CameraMeta("CAM_BACK", (900, 1600), egocar_visible=True),
        },
        calib_style="per_frame",
        world_anchor="front_cam",
    ),
    "kitti": DatasetLayout(
        name="kitti",
        cameras={
            0: CameraMeta("cam_left", (375, 1242)),
            1: CameraMeta("cam_right", (375, 1242)),
        },
        calib_style="ego_pose",
        world_anchor="ego",
    ),
    "nuplan": DatasetLayout(
        name="nuplan",
        cameras={
            0: CameraMeta("CAM_F0", (1080, 1920)),
            1: CameraMeta("CAM_L0", (1080, 1920)),
            2: CameraMeta("CAM_R0", (1080, 1920)),
            3: CameraMeta("CAM_L1", (1080, 1920)),
            4: CameraMeta("CAM_R1", (1080, 1920)),
            5: CameraMeta("CAM_L2", (1080, 1920), egocar_visible=True),
            6: CameraMeta("CAM_R2", (1080, 1920), egocar_visible=True),
            7: CameraMeta("CAM_B0", (1080, 1920), egocar_visible=True),
        },
        calib_style="ego_pose",
        lidar_format="nuplan6",
        world_anchor="ego",
    ),
}


def get_layout(dataset: Optional[str]) -> Optional[DatasetLayout]:
    if dataset is None:
        return None
    key = dataset.split("/")[0].lower()
    return DATASETS.get(key)
