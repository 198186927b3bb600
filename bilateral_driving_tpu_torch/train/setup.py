"""Scene and model construction from a scene's initial points: port of
bilateral_driving_tpu/train/setup.py for the vanilla, PVG and DeformableGS
Backgrounds, RigidNodes, SMPLNodes (with or without the voxel skinning
deformer), DeformableNodes, the EnvLight and MLP skies, every appearance
model (affine codes, the single, multi-scale, neural and CP-4D
bilateral grids) and camera refinement.

Every random draw (quaternions, colours, instance codes, the deformation
networks) comes from an explicit torch.Generator.
"""
from __future__ import annotations

import math

import torch

from ..core import sampling, sh as sh_lib
from ..models import affine as affine_mod
from ..models import bilateral, camera_opt, deform, encoders, sky as sky_mod
from ..scene import pvg as pvg_mod
from ..scene import smpl_model, smpl_node, voxel_deformer as vd

INIT_OPACITY = 0.1


def random_quats(generator: torch.Generator, n: int) -> torch.Tensor:
    """(n, 4) uniform random unit quaternions (reference basics.py:47-62)."""
    u, v, w = torch.rand((n, 3), generator=generator,
                         device=generator.device).unbind(-1)
    return torch.stack([
        torch.sqrt(1.0 - u) * torch.sin(2.0 * math.pi * v),
        torch.sqrt(1.0 - u) * torch.cos(2.0 * math.pi * v),
        torch.sqrt(u) * torch.sin(2.0 * math.pi * w),
        torch.sqrt(u) * torch.cos(2.0 * math.pi * w),
    ], dim=-1)


def gaussian_dict(generator, capacity: int, means, colors, scales,
                  sh_degree: int = 3, init_opacity: float = INIT_OPACITY):
    """Fixed-capacity Gaussian parameters of a point cloud and its liveness
    mask (create_from_pcd, vanilla.py:79-121): `scales` (N,) or (N, 3),
    random quats, the given opacity, SH DC from the colours; slots past the
    points are dead (mask False, logit -20, identity quats)."""
    n = means.shape[0]
    dev = means.device
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    if scales.dim() == 1:
        scales = scales[:, None].expand(n, 3)

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=dev)
        out[:n] = x
        return out

    quats = torch.zeros((capacity, 4), device=dev)
    quats[:, 0] = 1.0
    quats[:n] = random_quats(generator, n).to(dev)
    logit = torch.log(torch.tensor(init_opacity / (1.0 - init_opacity),
                                   dtype=torch.float32))
    k = sh_lib.num_sh_bases(sh_degree)
    params = {
        "means": pad(means),
        "log_scales": pad(torch.log(torch.clamp(scales, min=1e-8))),
        "quats": quats,
        "logit_opacities": pad(logit.expand(n, 1).to(dev), -20.0),
        "sh_dc": pad(sh_lib.rgb_to_sh(colors)[:, None, :]),
        "sh_rest": torch.zeros((capacity, k - 1, 3), device=dev),
    }
    mask = torch.arange(capacity, device=dev) < n
    return params, mask


def knn_scales(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Scale init from the mean 3-NN distance (basics.py:208-224)."""
    return torch.clamp(sampling.knn_mean_distance(points, k=k), min=1e-7)


def build_background(generator, capacity: int, means, colors,
                     sh_degree: int = 3):
    return gaussian_dict(generator, capacity, means, colors,
                         knn_scales(means), sh_degree)


def build_pvg_background(generator, capacity: int, means, colors,
                         t_init=None, sh_degree: int = 3,
                         beta_init: float = 0.1, time_scale: float = 1.0):
    """The vanilla Background plus PVG's taus, log betas and velocity;
    t_init: each point's normalized observation time, scaled into taus by
    time_scale = time_interval * (num_frames - 1) (pvg.py:47, 53)."""
    params, mask = build_background(generator, capacity, means, colors,
                                    sh_degree)
    params.update(pvg_mod.init_extras(capacity, means.shape[0], t_init,
                                      beta_init, time_scale, means.device))
    return params, mask


def build_deformgs_background(generator, capacity: int, means, colors,
                              aabb_center, aabb_radius, sh_degree: int = 3,
                              net_depth: int = 8, net_width: int = 256):
    """The DeformableGS Background (deformgs.py): canonical Gaussians and
    a DeformNetwork (U(+-1/sqrt(fan_in)) weights) under `deform_net`;
    statics carry the contraction's AABB centre and scale. Returns
    (params, statics, mask)."""
    params, mask = build_background(generator, capacity, means, colors,
                                    sh_degree)
    dev = means.device
    params["deform_net"] = deform.DeformNetwork(
        depth=net_depth, width=net_width).reset_parameters(generator).to(dev)
    statics = {"aabb_center": torch.as_tensor(aabb_center,
                                              dtype=torch.float32,
                                              device=dev),
               "aabb_scale": torch.tensor(float(aabb_radius), device=dev)}
    return params, statics, mask


def build_rigid(generator, capacity: int, means, colors, point_ids,
                quats_fi4, trans_fi3, frame_valid, sizes, sh_degree: int = 3):
    """means are instance-local; point_ids (N,) instance per point.
    Returns (params, statics, aux, mask)."""
    params, mask = gaussian_dict(generator, capacity, means, colors,
                                 knn_scales(means), sh_degree)
    params["instances_quats"] = quats_fi4
    params["instances_trans"] = trans_fi3
    statics = {"instances_fv": frame_valid, "instances_size": sizes}
    pid = torch.zeros((capacity,), dtype=torch.int32, device=means.device)
    pid[:point_ids.shape[0]] = point_ids.to(torch.int32)
    return params, statics, {"point_ids": pid}, mask


def build_deformable(generator, capacity: int, means, colors, point_ids,
                     quats_fi4, trans_fi3, frame_valid, sizes,
                     num_instances: int, sh_degree: int = 3,
                     embed_dim: int = 16, net_depth: int = 8,
                     net_width: int = 256):
    """RigidNodes plus per-instance codes and the conditional deformation
    network (U(+-1/sqrt(fan_in)) weights)."""
    params, statics, aux, mask = build_rigid(
        generator, capacity, means, colors, point_ids, quats_fi4, trans_fi3,
        frame_valid, sizes, sh_degree)
    dev = means.device
    params["instance_embeds"] = encoders.embedding_init(
        num_instances, embed_dim, generator, dev)
    params["deform_net"] = deform.DeformNetwork(
        depth=net_depth, width=net_width, embed_dim=embed_dim
    ).reset_parameters(generator).to(dev)
    return params, statics, aux, mask


def build_smpl(generator, model: smpl_model.SMPLModel, betas,
               root_quats_fi14, body_quats_fi234, trans_fi3, frame_valid,
               sh_degree: int = 3, init_opacity: float = 0.88,
               use_voxel_deformer: bool = False):
    """SMPL pedestrians: betas (I, 10), root quats (F, I, 1, 4), body quats
    (F, I, 23, 4), translations (F, I, 3), frame_valid (F, I). Points start
    on the canonical (da-pose) template vertices with uniform random
    colours and 0.01 scales; where the model has a mesh, normal-aligned
    quaternions and 1-ring disk scales (smpl_model.mesh_init_qso). Returns
    (params, statics, aux, mask); statics hold the template, the KNN
    indices of the regularisers and the init positions `on_mesh_x`. With
    `use_voxel_deformer` the statics also hold the deformer's voxel
    (`vd_statics`, built from the template's vertices and weights) and the
    parameters its zero correction `voxel_w_correction`."""
    template = smpl_model.make_template(model, betas)
    num_inst, V = template.verts_canonical.shape[:2]
    means = template.verts_canonical.reshape(-1, 3)
    dev = means.device
    n = means.shape[0]
    colors = torch.rand((n, 3), generator=generator,
                        device=generator.device).to(dev)
    params, mask = gaussian_dict(generator, n, means, colors,
                                 torch.full((n,), 0.01, device=dev),
                                 sh_degree, init_opacity)
    if model.faces.shape[0] > 1:
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                 device=generator.device))
        mq, ms = smpl_model.mesh_init_qso(
            template.verts_canonical.cpu().numpy(), model.faces, seed)
        params["quats"] = torch.from_numpy(mq).to(dev)
        params["log_scales"] = torch.from_numpy(ms).to(dev)
    params["instances_quats"] = root_quats_fi14
    params["smpl_quats"] = body_quats_fi234
    params["instances_trans"] = trans_fi3
    statics = {"template": template, "instances_fv": frame_valid,
               "nn_ind": smpl_node.compute_knn(means, num_inst, k=5),
               "on_mesh_x": means}
    if use_voxel_deformer:
        statics["vd_statics"], vd_params = vd.init_voxel_deformer(
            template.verts_canonical, template.lbs_weights)
        params["voxel_w_correction"] = vd_params["voxel_w_correction"]
    point_ids = torch.arange(num_inst, dtype=torch.int32,
                             device=dev).repeat_interleave(V)
    return params, statics, {"point_ids": point_ids}, mask


def build_models(cfg, device="cuda",
                 generator: torch.Generator | None = None):
    """The non-Gaussian models keyed as the trainer expects: the sky of
    cfg.sky_model ("Sky": the EnvLight texture, or the MLP sky drawn from
    `generator` before the appearance models; none for "none"), and
    appearance_models."""
    g = torch.Generator().manual_seed(0) if generator is None else generator
    out = {}
    if cfg.sky_model == "envlight":
        out["Sky"] = sky_mod.init_envlight(cfg.envlight_resolution, device)
    elif cfg.sky_model == "mlp":
        out["Sky"] = sky_mod.init_sky_mlp(cfg.num_images, g, device=device)
    elif cfg.sky_model != "none":
        raise ValueError(f"unknown sky_model {cfg.sky_model!r}: "
                         f"one of {sky_mod.SKY_MODELS}")
    return {**out, **appearance_models(cfg, device, g)}


def appearance_models(cfg, device="cuda",
                      generator: torch.Generator | None = None):
    """The appearance model of cfg.affine_model ("Affine") and the camera
    refinements ("CamPose" at zero, "CamPosePerturb" drawn with std 0.01).
    The MLPs, the CP-4D noise and the perturbation are drawn from
    `generator` (a CPU generator seeded 0 by default)."""
    g = torch.Generator().manual_seed(0) if generator is None else generator
    out = {}
    aff = cfg.affine_model
    if aff == "multiscale_bilateral":
        out["Affine"] = bilateral.init_multiscale(cfg.num_images, cfg.ms_grid,
                                                  device)
    elif aff == "bilateral":
        out["Affine"] = bilateral.init_bilateral(
            cfg.num_images, *cfg.bilateral_grid_shape, device=device)
    elif aff == "affine":
        out["Affine"] = affine_mod.init_affine(g, cfg.num_images,
                                               device=device)
    elif aff == "neural_bilateral":
        out["Affine"] = bilateral.init_neural_bilateral(
            g, cfg.num_images, *cfg.bilateral_grid_shape, feature_dim=8,
            hidden_dim=64, device=device)
    elif aff == "multiscale_neural_bilateral":
        out["Affine"] = bilateral.init_multiscale_neural(
            g, cfg.num_images, cfg.ms_grid, device=device)
    elif aff == "cp4d":
        out["Affine"] = bilateral.init_cp4d(g, device=device)
    elif aff != "none":
        raise ValueError(f"unknown affine_model {aff!r}")
    if cfg.use_camera_opt:
        out["CamPose"] = camera_opt.init_camera_opt(g, cfg.num_images,
                                                    device=device)
    if cfg.use_camera_perturb:
        out["CamPosePerturb"] = camera_opt.init_camera_opt(
            g, cfg.num_images, std=0.01, device=device)
    return out
