"""Static background Gaussians (vanilla): port of the render half of
bilateral_driving_tpu/scene/background.py."""
from __future__ import annotations

from typing import NamedTuple

from ..core import gaussians as G


class BackgroundConfig(NamedTuple):
    sh_degree: int = 3
    sh_degree_interval: int = 1000


def gaussians(params, mask, cam_origin, step: int,
              cfg: BackgroundConfig = BackgroundConfig()) -> G.Gaussians:
    return G.get_gaussians(params, mask, cam_origin, step,
                           cfg.sh_degree_interval, cfg.sh_degree)
