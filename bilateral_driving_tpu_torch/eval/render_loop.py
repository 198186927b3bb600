"""Render loop: port of `render_images` from
bilateral_driving_tpu/eval/render_loop.py, without metrics or video
writing (a later slice).

Test images (keys of `neighbor_map`) render with interpolated instance
poses and bilateral affines averaged over their neighbouring training
images; the rest render as training views.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..train import trainer as trainer_mod


def render_images(cfg, state: trainer_mod.SceneState, statics, data,
                  image_indices, neighbor_map: Optional[Dict] = None) -> Dict:
    """Render the given image indices of `data` (anything with
    `get_batch(idx)`). Returns lists: rgbs (clipped to [0, 1]), gt_rgbs,
    depths, opacities, sky_rgbs, num_isects and overflow."""
    full_statics = trainer_mod.merge_statics(statics, state.aux)
    out = {k: [] for k in ("rgbs", "gt_rgbs", "depths", "opacities",
                           "sky_rgbs", "num_isects", "overflow")}
    for idx in image_indices:
        batch = data.get_batch(int(idx))
        nbrs = None if neighbor_map is None else neighbor_map.get(int(idx))
        o = trainer_mod.forward(cfg, state.params, full_statics, state.masks,
                                batch, state.step,
                                in_test_set=nbrs is not None,
                                neighbor_idx=nbrs)
        out["rgbs"].append(torch.clamp(o["rgb"], 0.0, 1.0))
        out["gt_rgbs"].append(batch["pixels"])
        out["depths"].append(o["depth"][..., 0])
        out["opacities"].append(o["opacity"][..., 0])
        out["sky_rgbs"].append(o["rgb_sky"])
        out["num_isects"].append(o["info"]["num_isects"])
        out["overflow"].append(o["info"]["overflow"])
    return out
