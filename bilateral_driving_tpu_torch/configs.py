"""The flagship configuration as a Python preset.

The JAX package reads `bilateral_driving_tpu/configs/omnire_ms_bilateral.yaml`
through PyYAML; the port carries the settings its forward and training step
read here (render, model, loss weights, background regularisers, density
control and learning rates), so the card path needs no YAML parser. tests/test_torch_configs.py holds this
preset equal to what the JAX package builds from the YAML.
"""
from __future__ import annotations

import dataclasses

from .models import bilateral
from .train import density
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
    w_rgb=0.8,
    w_ssim=0.2,
    w_mask=0.05,
    w_depth=0.01,
    lidar_w_decay=-1.0,
    depth_loss_type="l1",
    max_depth=80.0,
    w_affine=0.01,
    w_affine_inverse=0.0,
    w_opacity_entropy=0.0,
    w_inverse_depth_smoothness=0.0,
    w_rigid_temporal=0.0,
    background_reg=(("sharp_shape_reg", (("w", 1.0), ("max_gauss_ratio", 10.0),
                                         ("step_interval", 10))),),
    density=density.DensityConfig(
        densify_grad_thresh=0.0005, densify_size_thresh=0.003,
        n_split_samples=2, cull_alpha_thresh=0.005, cull_scale_thresh=0.5,
        reset_alpha_interval=3000, reset_alpha_value=0.01,
        refine_interval=100, warmup_steps=500, stop_split_at=15000,
        stop_screen_size_at=4000),
    max_steps=30000,
)
# background_init.capacity and trainer.max_steps of the same YAML
FLAGSHIP_BG_CAPACITY = 2097152
FLAGSHIP_MAX_STEPS = FLAGSHIP["max_steps"]


def flagship_config(num_images: int, num_frames: int,
                    **overrides) -> TrainerConfig:
    """TrainerConfig of omnire_ms_bilateral for a scene's image and frame
    counts; `overrides` replace single fields (e.g. isect_capacity)."""
    cfg = TrainerConfig(num_images=num_images, num_frames=num_frames,
                        **FLAGSHIP)
    return dataclasses.replace(cfg, **overrides)
