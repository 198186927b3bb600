"""The flagship configuration as a Python preset.

The JAX package reads `bilateral_driving_tpu/configs/omnire_ms_bilateral.yaml`
through PyYAML; the port carries the settings its forward reads here, so the
card path needs no YAML parser. tests/test_torch_configs.py holds this
preset equal to what the JAX package builds from the YAML.
"""
from __future__ import annotations

import dataclasses

from .models import bilateral
from .train.trainer import TrainerConfig

FLAGSHIP = dict(
    background_model="vanilla",
    use_rigid=True,
    use_smpl=False,
    use_deformable=True,
    sky_model="envlight",
    affine_model="multiscale_bilateral",
    use_camera_opt=False,
    use_camera_perturb=False,
    near_plane=0.1,
    far_plane=1e10,
    radius_clip=0.0,
    antialiased=False,
    isect_capacity=2097152,
    sh_degree=3,
    sh_degree_interval=1000,
    ms_grid=bilateral.DEFAULT_MS_GRID,
    guidance_factor=bilateral.DEFAULT_GUIDANCE_FACTOR,
    envlight_resolution=1024,
    w_dynamic_region=0.0,
)
# background_init.capacity and trainer.max_steps of the same YAML
FLAGSHIP_BG_CAPACITY = 2097152
FLAGSHIP_MAX_STEPS = 30000


def flagship_config(num_images: int, num_frames: int,
                    **overrides) -> TrainerConfig:
    """TrainerConfig of omnire_ms_bilateral for a scene's image and frame
    counts; `overrides` replace single fields (e.g. isect_capacity)."""
    cfg = TrainerConfig(num_images=num_images, num_frames=num_frames,
                        **FLAGSHIP)
    return dataclasses.replace(cfg, **overrides)
