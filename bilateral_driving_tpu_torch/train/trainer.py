"""Scene trainer: port of bilateral_driving_tpu/train/trainer.py for the
vanilla, PVG and DeformableGS backgrounds with rigid, SMPL (with or
without the voxel skinning deformer) and deformable nodes, the EnvLight,
MLP or no sky, every appearance model and camera refinement
(configs.PRESETS, or any tree of the JAX package's schema).

forward = camera refinement -> per-class Gaussians -> concat -> tiled
rasterize -> sky compositing -> appearance (affine codes, or the
single, multi-scale, neural or CP-4D bilateral grids). A training
step is compute_grads (forward, the loss stack and autograd, with a zeros
`means2d_dummy` whose gradient is the per-Gaussian screen gradient) then
apply_grads_and_refine (Adam per parameter group at its scheduled rate,
densification statistics and, every refine_interval steps, refinement of
every class but the fixed-size SMPLNodes; PVG's temporal densification
with it). PVG's temporal smoothing draws its offset from the state's
generator.

The JAX trainer is pure; here the state is updated in place: the optimizer
steps the parameter tensors and refinement writes into them, so the
optimizer keeps its hold on every parameter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from ..models import affine as affine_mod
from ..models import bilateral, camera_opt, sky as sky_mod
from ..ops import pipeline
from ..ops.camera import viewmat_from_c2w
from ..scene import background, deformable, nodes, pvg, rigid, smpl_node
from . import density, losses, schedules


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    # class toggles
    background_model: str = "vanilla"      # vanilla | pvg | deformgs
    use_rigid: bool = False
    use_smpl: bool = False
    use_deformable: bool = False
    sky_model: str = "envlight"
    affine_model: str = "multiscale_bilateral"   # multiscale_bilateral |
    # bilateral | affine | neural_bilateral | multiscale_neural_bilateral |
    # cp4d | none
    use_camera_opt: bool = False
    use_camera_perturb: bool = False
    use_voxel_deformer: bool = False

    # render
    near_plane: float = 0.1
    far_plane: float = 10000000.0
    radius_clip: float = 0.0
    antialiased: bool = False
    isect_capacity: int = 2 ** 20
    sh_degree: int = 3
    sh_degree_interval: int = 1000

    # PVG's temporal model (pvg.yaml pvg block): normalized batch times
    # map onto the scaled axis, pvg_time_interval per frame (pvg.py:46-47)
    pvg_cycle: float = 0.2
    pvg_time_interval: float = 0.02
    pvg_temporal_smoothing: bool = False
    pvg_smooth_probability: float = 0.5
    pvg_distribution_span: float = 1.5     # in frame intervals

    # appearance and sky
    ms_grid: tuple = bilateral.DEFAULT_MS_GRID
    guidance_factor: tuple = bilateral.DEFAULT_GUIDANCE_FACTOR
    bilateral_grid_shape: tuple = (16, 16, 8)
    envlight_resolution: int = 256
    num_images: int = 1
    num_frames: int = 1

    # loss weights
    w_rgb: float = 0.8
    w_ssim: float = 0.2
    w_mask: float = 0.05
    w_depth: float = 0.01
    lidar_w_decay: float = -1.0
    w_affine: float = 0.00001
    w_affine_inverse: float = 0.0
    w_opacity_entropy: float = 0.0
    w_inverse_depth_smoothness: float = 0.0
    depth_loss_type: str = "l1"
    depth_inverse: bool = False
    depth_normalize: bool = False
    depth_reduction: str = "mean_on_hit"
    mask_loss_type: str = "safe_bce"       # safe_bce | bce
    max_depth: float = 80.0

    # per-class regularisers: (("name", (("key", value), ...)), ...)
    background_reg: tuple = ()
    smpl_reg: tuple = ()
    w_rigid_temporal: float = 0.0
    w_smpl_joint_smooth: float = 0.0
    # dynamic-region loss weight: > 0 adds a dynamic-classes-only opacity
    # render to the training forward
    w_dynamic_region: float = 0.0
    dynamic_region_start_from: int = 0

    # density control
    density: density.DensityConfig = density.DensityConfig()
    scene_scale: float = 1.0
    scene_origin: tuple = (0.0, 0.0, 0.0)

    # optimisation: (group, lr_init, lr_final, warmup_steps), the JAX
    # package's table; "means" and "velocity" are scaled by scene_scale
    lr: tuple = (
        ("means", 1.6e-4, 1.6e-6, 0),
        ("means_deform", 3.2e-4, 3.2e-6, 0),
        ("means_smpl", 4.8e-4, 4.8e-6, 0),
        ("log_scales", 5e-3, None, 0),
        ("quats", 1e-3, None, 0),
        ("logit_opacities", 5e-2, None, 0),
        ("sh_dc", 2.5e-3, None, 0),
        ("sh_rest", 1.25e-4, None, 0),
        ("instances_quats", 1e-5, 5e-6, 0),
        ("instances_trans", 5e-4, 1e-4, 0),
        ("smpl_quats", 5e-5, 1e-5, 0),
        ("velocity", 1e-3, None, 0),
        ("taus", 8e-4, 8e-6, 0),
        ("log_betas", 2e-3, None, 0),
        ("sky", 1e-2, None, 0),
        ("affine", 6e-4, 3e-5, 1000),
        ("camera_opt", 1e-5, None, 0),
        ("deform_net", 8e-3, 8e-4, 0),
        ("deform_net_bg", 8e-4, 8e-6, 0),
        ("instance_embeds", 1e-3, 1e-4, 0),
        ("voxel_w_correction", 1e-4, 1e-5, 10000),
        ("other", 1e-3, None, 0),
    )
    max_steps: int = 30000


class SceneState(NamedTuple):
    """What rendering needs of a trained scene."""
    params: Any       # class name -> parameter dict (see core.gaussians)
    aux: Any          # class name -> per-point arrays (point_ids)
    masks: Any        # class name -> (C,) liveness
    step: int


def _check_ported(cfg: TrainerConfig):
    if cfg.background_model not in ("vanilla", "pvg", "deformgs"):
        raise ValueError(f"unknown background_model "
                         f"{cfg.background_model!r}")
    if cfg.sky_model not in sky_mod.SKY_MODELS:
        raise ValueError(f"unknown sky_model {cfg.sky_model!r}: one of "
                         f"{sky_mod.SKY_MODELS}")


def gaussian_classes(cfg: TrainerConfig):
    out = []
    if cfg.background_model != "none":
        out.append("Background")
    if cfg.use_rigid:
        out.append("RigidNodes")
    if cfg.use_smpl:
        out.append("SMPLNodes")
    if cfg.use_deformable:
        out.append("DeformableNodes")
    return out


def merge_statics(statics, aux):
    """Combine immutable statics with per-point aux arrays per class."""
    return {name: {**statics.get(name, {}), **aux.get(name, {})}
            for name in set(statics) | set(aux)}


def collect_gaussians(cfg: TrainerConfig, params, statics, masks, cam_origin,
                      step: int, frame: int, t: float,
                      in_test_set: bool = False, opacity_multiplier=None,
                      time_offset=0.0):
    """Per-class Gaussians + concat. `statics[name]` already holds that
    class's aux arrays (see merge_statics). `opacity_multiplier` (N,)
    scales the concatenated opacities (the per-class decomposed renders
    zero every class but one). `time_offset`: PVG's temporal smoothing
    offset of the normalized time (a float or a 0-d tensor)."""
    _check_ported(cfg)
    bundles = {}
    bg = params["Background"]
    if cfg.background_model == "vanilla":
        bundles["Background"] = background.gaussians(
            bg, masks["Background"], cam_origin, step,
            background.BackgroundConfig(cfg.sh_degree,
                                        cfg.sh_degree_interval))
    elif cfg.background_model == "pvg":
        # rendered at t1 = t + offset with a linear velocity correction
        # back toward the train time t (delta_t = -offset), on the scaled
        # time axis (pvg.py:375-389)
        ts = cfg.pvg_time_interval * max(cfg.num_frames - 1, 1)
        # the time in the parameters' precision, as the JAX package forms it
        tt = torch.full((), t, dtype=bg["taus"].dtype,
                        device=bg["taus"].device)
        bundles["Background"] = pvg.gaussians(
            bg, masks["Background"], cam_origin, step,
            (tt + time_offset) * ts,
            pvg.PVGConfig(cfg.sh_degree, cfg.sh_degree_interval,
                          cycle=cfg.pvg_cycle),
            smooth_delta_t=-time_offset * ts)
    else:
        st = statics.get("Background", {})
        bundles["Background"] = deformable.deformgs_gaussians(
            bg, bg["deform_net"], masks["Background"], cam_origin, step, t,
            st["aabb_center"], st["aabb_scale"],
            deformable.DeformableConfig(cfg.sh_degree,
                                        cfg.sh_degree_interval))
    if cfg.use_rigid:
        bundles["RigidNodes"] = rigid.gaussians(
            params["RigidNodes"], statics["RigidNodes"], masks["RigidNodes"],
            cam_origin, step, frame, cfg.num_frames, in_test_set,
            rigid.RigidConfig(cfg.sh_degree, cfg.sh_degree_interval))
    if cfg.use_smpl:
        bundles["SMPLNodes"] = smpl_node.gaussians(
            params["SMPLNodes"], statics["SMPLNodes"], masks["SMPLNodes"],
            cam_origin, step, frame, cfg.num_frames, in_test_set,
            smpl_node.SMPLConfig(cfg.sh_degree, cfg.sh_degree_interval,
                                 use_voxel_deformer=cfg.use_voxel_deformer),
            vd_statics=statics["SMPLNodes"].get("vd_statics"))
    if cfg.use_deformable:
        bundles["DeformableNodes"] = deformable.node_gaussians(
            params["DeformableNodes"], statics["DeformableNodes"],
            masks["DeformableNodes"], cam_origin, step, frame,
            cfg.num_frames, t, in_test_set,
            deformable.DeformableConfig(cfg.sh_degree,
                                        cfg.sh_degree_interval))
    merged, labels = nodes.concat_bundles(bundles)
    if opacity_multiplier is not None:
        merged = merged._replace(
            opacities=merged.opacities * opacity_multiplier)
    return merged, labels


def forward(cfg: TrainerConfig, params, statics, masks, batch, step: int,
            in_test_set: bool = False, novel_view: bool = False,
            neighbor_idx=None, means2d_dummy=None, opacity_multiplier=None,
            time_offset=0.0, rasterize_fn=None):
    """Render one camera, differentiably where grad mode is on.

    batch: camera_to_world (4, 4), intrinsics (3, 3), pixels (H, W, 3),
    viewdirs (H, W, 3) world view directions, img_idx, frame_idx (ints) and
    normed_time (float). On training views the camera refinements move the
    camera-to-world (the perturbation first), and the refined pose gives
    both the view matrix and the SH camera origin. On test views,
    `neighbor_idx` lists the training images whose bilateral grids are
    averaged, and the affine codes take their mean embedding.
    `means2d_dummy`: (N, 2) zeros whose gradient is the screen-space
    gradient of each Gaussian; `opacity_multiplier` and `time_offset`: see
    collect_gaussians. `rasterize_fn` replaces pipeline.rasterize with the
    same call contract (the tile-parallel trainer renders bands through
    it, parallel/tile_parallel.py); every other stage stays as it is.
    """
    h, w = batch["pixels"].shape[:2]
    c2w = batch["camera_to_world"]
    img_idx = int(batch["img_idx"])
    if not novel_view and not in_test_set:
        if cfg.use_camera_perturb:
            c2w = camera_opt.apply_camera_opt(params["CamPosePerturb"], c2w,
                                              img_idx)
        if cfg.use_camera_opt:
            c2w = camera_opt.apply_camera_opt(params["CamPose"], c2w,
                                              img_idx)
    viewmat = viewmat_from_c2w(c2w)
    frame = int(batch["frame_idx"])
    merged, labels = collect_gaussians(
        cfg, params, statics, masks, c2w[:3, 3], step, frame,
        float(batch["normed_time"]), in_test_set, opacity_multiplier,
        time_offset)

    rcfg = pipeline.RasterizeConfig(
        near_plane=cfg.near_plane, far_plane=cfg.far_plane,
        radius_clip=cfg.radius_clip, antialiased=cfg.antialiased,
        isect_capacity=cfg.isect_capacity)
    out = (rasterize_fn or pipeline.rasterize)(
        merged.means, merged.quats, merged.scales, merged.opacities,
        merged.rgbs, viewmat, batch["intrinsics"], w, h, rcfg,
        means2d_dummy=means2d_dummy)

    rgb_gaussians = torch.clamp(out["rgb"], max=1.0)
    opacity = out["alpha"]
    outputs = {
        "rgb_gaussians": rgb_gaussians,
        "depth": out["depth"],
        "opacity": opacity,
        "info": out["info"],
        "labels": labels,
    }

    if (cfg.w_dynamic_region > 0 and len(gaussian_classes(cfg)) > 1
            and not in_test_set and not novel_view):
        # dynamic-classes-only opacity: zero Background opacities render
        # exactly like leaving the Background out
        with torch.no_grad():
            dyn_op = torch.where(
                labels != nodes.NODE_CLASS_IDS["Background"],
                merged.opacities, torch.zeros_like(merged.opacities))
            dyn = pipeline.rasterize(
                merged.means, merged.quats, merged.scales, dyn_op,
                merged.rgbs, viewmat, batch["intrinsics"], w, h, rcfg)
        outputs["Dynamic_opacity"] = dyn["alpha"]

    if cfg.sky_model == "envlight":
        rgb_sky = sky_mod.envlight_color(params["Sky"], batch["viewdirs"])
    elif cfg.sky_model == "mlp":
        rgb_sky = sky_mod.sky_mlp_color(params["Sky"], batch["viewdirs"],
                                        img_idx,
                                        use_mean_embedding=in_test_set)
    else:
        rgb_sky = torch.zeros_like(rgb_gaussians)
    outputs["rgb_sky"] = rgb_sky
    original_rgb = rgb_gaussians + rgb_sky * (1.0 - opacity)
    outputs["original_rgb"] = original_rgb

    neighbors = neighbor_idx if in_test_set else None
    aff, affine = cfg.affine_model, params.get("Affine")
    if aff == "multiscale_bilateral":
        mats_list = bilateral.multiscale_affines(
            affine, original_rgb, img_idx, cfg.guidance_factor,
            neighbor_idx=neighbors)
        outputs["affine_mats"] = mats_list
        outputs["rgb"] = bilateral.compose_affines(mats_list, original_rgb)
    elif aff == "bilateral":
        mats = bilateral.bilateral_affines(affine, original_rgb, img_idx,
                                           neighbor_idx=neighbors)
        outputs["rgb"] = bilateral.apply_affine(mats, original_rgb)
    elif aff == "affine":
        mats = affine_mod.affine_mats(affine, img_idx,
                                      use_mean_embedding=in_test_set)
        outputs["rgb"] = bilateral.apply_affine(mats, original_rgb)
        outputs["affine_single"] = mats
    elif aff in ("neural_bilateral", "multiscale_neural_bilateral"):
        if aff == "neural_bilateral":
            mats = bilateral.neural_bilateral_affines(
                affine, original_rgb, img_idx, neighbor_idx=neighbors)
        else:
            mats = bilateral.multiscale_neural_affines(
                affine, original_rgb, img_idx, cfg.guidance_factor,
                neighbor_idx=neighbors)
        # applied residually
        outputs["rgb"] = bilateral.apply_affine(mats, original_rgb) \
            + original_rgb
    elif aff == "cp4d":
        # sliced at a screen-space xyz: (x, y) over linspace(-1, 1), depth
        # over max_depth, from the detached depth
        dt = original_rgb.dtype
        yy, xx = torch.meshgrid(
            torch.linspace(-1.0, 1.0, h, dtype=dt, device=c2w.device),
            torch.linspace(-1.0, 1.0, w, dtype=dt, device=c2w.device),
            indexing="ij")
        dz = torch.clamp(out["depth"][..., 0].detach() / cfg.max_depth,
                         0.0, 1.0) * 2 - 1
        mats = bilateral.cp4d_affines(
            affine, torch.stack([xx, yy, dz], dim=-1), original_rgb)
        outputs["rgb"] = bilateral.apply_affine(mats, original_rgb)
    else:
        outputs["rgb"] = original_rgb
    return outputs


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _regs(pairs) -> dict:
    """(("name", (("key", value), ...)), ...) config tuples -> dict."""
    return {k: dict(v) for k, v in pairs}


def compute_losses(cfg: TrainerConfig, params, statics, masks, outputs,
                   batch, step: int) -> Dict[str, torch.Tensor]:
    """The loss stack, each term weighted."""
    loss = {}
    pixels = batch["pixels"]
    if "egocar_masks" in batch:
        valid = 1.0 - batch["egocar_masks"]
    else:
        valid = torch.ones(pixels.shape[:2], dtype=pixels.dtype,
                           device=pixels.device)
    gt_rgb = pixels * valid[..., None]
    pred_rgb = outputs["rgb"] * valid[..., None]
    loss["rgb"] = cfg.w_rgb * losses.l1(gt_rgb, pred_rgb)
    loss["ssim"] = cfg.w_ssim * (1.0 - losses.ssim(gt_rgb, pred_rgb))

    if cfg.w_mask > 0 and "sky_masks" in batch:
        gt_occ = (1.0 - batch["sky_masks"]) * valid
        pred_occ = outputs["opacity"][..., 0] * valid
        bce = losses.bce if cfg.mask_loss_type == "bce" else losses.safe_bce
        loss["sky_opacity"] = cfg.w_mask * bce(pred_occ, gt_occ)

    if cfg.w_depth > 0 and "lidar_depth_map" in batch:
        decay = (torch.exp(torch.tensor(-step / 8000.0 * cfg.lidar_w_decay))
                 if cfg.lidar_w_decay > 0 else 1.0)
        lidar = batch["lidar_depth_map"]
        hit = (lidar > 0).to(lidar.dtype) * valid
        loss["depth"] = cfg.w_depth * decay * losses.depth_loss(
            outputs["depth"][..., 0], lidar, hit,
            loss_type=cfg.depth_loss_type, normalize=cfg.depth_normalize,
            use_inverse_depth=cfg.depth_inverse, max_depth=cfg.max_depth,
            reduction=cfg.depth_reduction)

    if cfg.w_dynamic_region > 0 and "Dynamic_opacity" in outputs:
        # masked L1 over the pixels the dynamic-only render covers
        dyn_mask = ((outputs["Dynamic_opacity"][..., 0] > 0.2)
                    .to(valid.dtype) * valid)
        cnt = torch.sum(dyn_mask)
        l1_sum = torch.sum(torch.abs(gt_rgb - pred_rgb) * dyn_mask[..., None])
        active = (step > cfg.dynamic_region_start_from) & (cnt > 0)
        loss["vehicle_region_rgb"] = torch.where(
            active, cfg.w_dynamic_region * l1_sum
            / torch.clamp(cnt * 3.0, min=1.0), torch.zeros_like(l1_sum))

    if cfg.w_opacity_entropy > 0:
        loss["opacity_entropy"] = cfg.w_opacity_entropy * \
            losses.opacity_entropy(outputs["opacity"][..., 0])
    if cfg.w_inverse_depth_smoothness > 0:
        inv_d = 1.0 / (outputs["depth"][..., 0] + 1e-5)
        loss["inverse_depth_smoothness"] = \
            cfg.w_inverse_depth_smoothness * losses.inverse_depth_smoothness(
                inv_d, pixels)

    aff = cfg.affine_model
    if aff in ("multiscale_bilateral", "multiscale_neural_bilateral"):
        loss["affine"] = cfg.w_affine * bilateral.multiscale_tv_loss(
            params["Affine"], cfg.ms_grid)
        if aff == "multiscale_bilateral" and cfg.w_affine_inverse > 0:
            loss["affine"] = loss["affine"] + cfg.w_affine_inverse * \
                bilateral.inverse_loss(outputs["affine_mats"], gt_rgb,
                                       outputs["original_rgb"]
                                       * valid[..., None])
    elif aff in ("bilateral", "neural_bilateral"):
        loss["affine"] = cfg.w_affine * bilateral.bilateral_tv_loss(
            params["Affine"])
    elif aff == "cp4d":
        loss["affine"] = cfg.w_affine * bilateral.cp4d_tv_loss(
            params["Affine"])
    elif aff == "affine":
        loss["affine"] = cfg.w_affine * affine_mod.identity_reg_loss(
            outputs["affine_single"])

    if cfg.background_reg:
        regs = _regs(cfg.background_reg)
        vel = regs.pop("velocity_reg", None)    # PVG backgrounds only
        # this step's Background radii (the Background comes first)
        bg_radii = outputs["info"]["radii"][:masks["Background"].shape[0]]
        for k, v in background.reg_loss(params["Background"],
                                        masks["Background"], step, regs,
                                        cur_radii=bg_radii).items():
            loss[f"Background_{k}"] = v
        if vel is not None and cfg.background_model == "pvg":
            loss["Background_velocity_reg"] = pvg.velocity_reg_loss(
                params["Background"], masks["Background"], bg_radii,
                vel.get("w", 0.001), pvg.PVGConfig(cycle=cfg.pvg_cycle))
    if cfg.use_rigid and cfg.w_rigid_temporal > 0:
        # one weight for translation and rotation, as the JAX package has
        loss["RigidNodes_temporal"] = rigid.temporal_smoothness_loss(
            params["RigidNodes"], statics["RigidNodes"],
            cfg.w_rigid_temporal, cfg.w_rigid_temporal)
    frame = int(batch["frame_idx"])
    if cfg.use_smpl and cfg.w_smpl_joint_smooth > 0:
        loss["SMPLNodes_joint_smooth"] = smpl_node.joint_smoothness_loss(
            params["SMPLNodes"], statics["SMPLNodes"], frame, cfg.num_frames,
            cfg.w_smpl_joint_smooth)
    if cfg.use_smpl and cfg.smpl_reg:
        nn_ind = statics["SMPLNodes"].get("nn_ind")
        if nn_ind is not None:
            for k, v in smpl_node.knn_reg_loss(
                    params["SMPLNodes"], statics["SMPLNodes"], nn_ind, frame,
                    _regs(cfg.smpl_reg)).items():
                loss[f"SMPLNodes_{k}"] = v
    return loss


# --------------------------------------------------------------------------
# parameters and optimizer
# --------------------------------------------------------------------------


# per-point and per-track keys that name their own parameter group
_KNOWN = frozenset({"means", "log_scales", "quats", "logit_opacities",
                    "sh_dc", "sh_rest", "instances_quats", "instances_trans",
                    "smpl_quats", "velocity", "taus", "log_betas"})


def label_for_path(name: str) -> str:
    """Parameter group of a leaf from its "/"-joined path of keys (the JAX
    package's `_label_for_path`)."""
    keys = name.split("/")
    top = keys[0]
    if top == "Sky":
        return "sky"
    if top == "Affine":
        return "affine"
    if top in ("CamPose", "CamPosePerturb"):
        return "camera_opt"
    for k in keys:
        if k == "means" and top == "DeformableNodes":
            return "means_deform"
        if k == "means" and top == "SMPLNodes":
            return "means_smpl"
        if k in _KNOWN:
            return k
        if k == "deform_net":
            return "deform_net_bg" if top == "Background" else "deform_net"
        if k in ("instance_embeds", "voxel_w_correction"):
            return k
    return "other"


def named_leaves(params, prefix: str = ""):
    """("/"-joined path, tensor) of every trainable leaf: dicts and lists
    recurse, a module contributes its named parameters under its key."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from named_leaves(v, f"{prefix}{i}/")
    elif isinstance(params, torch.nn.Module):
        for name, p in params.named_parameters():
            yield prefix + name, p
    elif isinstance(params, torch.Tensor) and params.is_floating_point():
        yield prefix[:-1], params


def make_schedules(cfg: TrainerConfig) -> Dict[str, Any]:
    """Group -> learning-rate schedule of the optimizer's update count."""
    radius_scaled = ("means", "velocity")
    out = {}
    for name, init, final, warmup in cfg.lr:
        scale = cfg.scene_scale if name in radius_scaled else 1.0
        out[name] = schedules.make_schedule(schedules.LRConfig(
            lr_init=init * scale,
            lr_final=(final * scale) if final else final,
            max_steps=cfg.max_steps, warmup_steps=warmup, lr_pre_warmup=0.0))
    return out


def make_optimizer(cfg: TrainerConfig, params) -> torch.optim.Adam:
    """Adam (eps 1e-15) with one parameter group per label; each group's
    `lr` is set from its schedule before every update."""
    groups: Dict[str, list] = {}
    for name, p in named_leaves(params):
        groups.setdefault(label_for_path(name), []).append(p)
    known = {name for name, *_ in cfg.lr}
    missing = set(groups) - known
    if missing:
        raise ValueError(f"no learning rate for groups {sorted(missing)}")
    return torch.optim.Adam(
        [{"params": ps, "label": name, "lr": 0.0}
         for name, ps in groups.items()], eps=1e-15)


@dataclasses.dataclass
class TrainerState:
    """Mutable training state. `updates` counts the optimizer's own updates
    (the schedules follow it, as optax's scale_by_schedule counts its own),
    `step` the training step (refinement and the SH degree follow it)."""
    params: Any
    aux: Any
    masks: Any
    stats: Any            # class name -> density.DensityStats
    opt: torch.optim.Adam
    step: int
    generator: torch.Generator
    updates: int = 0


def init_state(cfg: TrainerConfig, params, masks, aux=None, step: int = 0,
               generator: torch.Generator | None = None) -> TrainerState:
    """Every floating tensor of `params` becomes a trainable leaf; fresh
    Adam moments and zero density statistics."""
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    dev = masks["Background"].device
    stats = {name: density.DensityStats.zeros(masks[name].shape[0], dev)
             for name in gaussian_classes(cfg)}
    aux = {**{name: {} for name in gaussian_classes(cfg)}, **(aux or {})}
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return TrainerState(params, aux, masks, stats, make_optimizer(cfg, params),
                        step, generator)


# --------------------------------------------------------------------------
# step
# --------------------------------------------------------------------------


def temporal_offset(cfg: TrainerConfig, generator: torch.Generator):
    """PVG's temporal smoothing offset of the normalized time: with
    probability pvg_smooth_probability a draw from +-distribution_span
    frame intervals, else 0 (pvg.py:375-389); a 0-d tensor on the
    generator's device (no host sync), or 0.0 without smoothing."""
    if not (cfg.background_model == "pvg" and cfg.pvg_temporal_smoothing):
        return 0.0
    u = torch.rand((2,), generator=generator, device=generator.device)
    bound = cfg.pvg_distribution_span / max(cfg.num_frames - 1, 1)
    offs = (2.0 * u[1] - 1.0) * bound
    return torch.where(u[0] < cfg.pvg_smooth_probability, offs,
                       torch.zeros_like(offs))


def compute_grads(cfg: TrainerConfig, statics, state: TrainerState, batch,
                  time_offset=None, rasterize_fn=None):
    """Gradients of one image: (total, loss dict, outputs, grads by leaf
    path, screen-space gradient (N, 2) of the concatenated Gaussians).
    `time_offset`: PVG's smoothing offset, drawn from the state's
    generator when None; `rasterize_fn`: see forward."""
    if time_offset is None:
        time_offset = temporal_offset(cfg, state.generator)
    full_statics = merge_statics(statics, state.aux)
    n_total = sum(state.masks[n].shape[0] for n in gaussian_classes(cfg))
    dev = state.masks["Background"].device
    leaves = list(named_leaves(state.params))
    with torch.enable_grad():
        dummy = torch.zeros((n_total, 2), device=dev, requires_grad=True)
        outputs = forward(cfg, state.params, full_statics, state.masks, batch,
                          state.step, means2d_dummy=dummy,
                          time_offset=time_offset, rasterize_fn=rasterize_fn)
        loss = compute_losses(cfg, state.params, full_statics, state.masks,
                              outputs, batch, state.step)
        total = sum(loss.values())
        grads = torch.autograd.grad(total, [p for _, p in leaves] + [dummy],
                                    allow_unused=True)
    g_params = {name: (torch.zeros_like(p) if g is None else g)
                for (name, p), g in zip(leaves, grads[:-1])}
    g_dummy = grads[-1] if grads[-1] is not None else torch.zeros_like(dummy)
    return total.detach(), {k: v.detach() for k, v in loss.items()}, \
        outputs, g_params, g_dummy


def image_psnr(outputs, batch) -> torch.Tensor:
    """The step's PSNR metric: the render against the batch's pixels."""
    return losses.psnr(outputs["rgb"].detach(), batch["pixels"])


@torch.no_grad()
def apply_grads_and_refine(cfg: TrainerConfig, statics, state: TrainerState,
                           batch, total, loss_dict, outputs, g_params,
                           g_dummy):
    """Optimizer update, density statistics and periodic refinement, in
    place. Returns (state, metrics) with state.step advanced by one."""
    info = outputs["info"]
    return update_and_refine(
        cfg, statics, state, batch["pixels"].shape[:2], total, loss_dict,
        g_params, g_dummy, info["radii"], info["overflow"],
        info["num_isects"], image_psnr(outputs, batch))


@torch.no_grad()
def update_and_refine(cfg: TrainerConfig, statics, state: TrainerState,
                      image_hw, total, loss_dict, g_params, g_dummy, radii,
                      overflow, num_isects, psnr):
    """apply_grads_and_refine on the step's reductions: the image's (h, w),
    the total and loss dict, the gradients and the screen-gradient dummy,
    the per-Gaussian radii, the overflow flag, num_isects and the PSNR
    metric (the parallel steps pass them reduced over their ranks)."""
    scheds = make_schedules(cfg)
    for name, p in named_leaves(state.params):
        p.grad = g_params[name]
    for group in state.opt.param_groups:
        group["lr"] = scheds[group["label"]](state.updates)
    state.opt.step()
    state.opt.zero_grad(set_to_none=True)
    state.updates += 1

    # screen-space statistics, scaled by (W/2, H/2) as the reference does
    # before the norm (densify_grad_thresh is tuned for that scale)
    h, w = image_hw
    last_size = float(max(h, w))
    grad_scale = torch.tensor([w / 2.0, h / 2.0], device=g_dummy.device)
    offset = 0
    is_pvg = cfg.background_model == "pvg"
    for name in gaussian_classes(cfg):
        c = state.masks[name].shape[0]
        # |dL/dtau| drives PVG's temporal densification (pvg.py:113-125)
        t_grad = (g_params["Background/taus"]
                  if is_pvg and name == "Background" else None)
        state.stats[name] = density.accumulate_stats(
            state.stats[name], g_dummy[offset:offset + c] * grad_scale,
            radii[offset:offset + c], last_size, t_grad=t_grad)
        offset += c

    step = state.step
    refine_dropped = torch.zeros((), dtype=torch.long,
                                 device=g_dummy.device)
    if step % cfg.density.refine_interval == 0 and step > 0:
        full_statics = merge_statics(statics, state.aux)
        for name in gaussian_classes(cfg):
            if name == "SMPLNodes":
                # a fixed point count: no densification, culling or
                # opacity reset, and its Adam moments are kept
                continue
            params = state.params[name]
            extra_cull = (rigid.out_of_bound_mask(params, full_statics[name])
                          if name in ("RigidNodes", "DeformableNodes")
                          else None)
            p, a, alive, touched, info = density.refine(
                state.generator, params, state.aux[name], state.masks[name],
                state.stats[name], step, cfg.scene_scale, cfg.density,
                num_train_images=cfg.num_images, extra_cull=extra_cull,
                pvg_cycle=(cfg.pvg_cycle if is_pvg and name == "Background"
                           else None), scene_origin=cfg.scene_origin)
            for k in density.PER_POINT_KEYS & set(params):
                params[k].copy_(p[k])
            state.aux[name] = a
            state.masks[name] = alive
            state.stats[name] = density.DensityStats.zeros(alive.shape[0],
                                                           alive.device)
            density.reset_moments(state.opt, params, touched)
            if info["opacity_reset"]:
                density.reset_moments(state.opt, params,
                                      torch.ones_like(touched),
                                      also_key="logit_opacities")
            refine_dropped = refine_dropped + info["dropped"]

    metrics = {"loss": total,
               "psnr": psnr,
               "isect_overflow": overflow.to(torch.float32),
               "num_isects": num_isects.to(torch.float32),
               "refine_dropped": refine_dropped.to(torch.float32),
               "nonfinite_params": sum(
                   torch.sum(~torch.isfinite(p)).to(torch.float32)
                   for _, p in named_leaves(state.params))}
    metrics.update({f"loss/{k}": v for k, v in loss_dict.items()})
    for name in gaussian_classes(cfg):
        metrics[f"num_points/{name}"] = torch.sum(state.masks[name]).to(
            torch.float32)
    state.step += 1
    return state, metrics


def train_step(cfg: TrainerConfig, statics, state: TrainerState, batch):
    """One optimization step: gradients, Adam update, density statistics
    and (every refine_interval steps) refinement. Updates `state` in place
    and returns (state, metrics)."""
    total, loss_dict, outputs, g_params, g_dummy = compute_grads(
        cfg, statics, state, batch)
    return apply_grads_and_refine(cfg, statics, state, batch, total,
                                  loss_dict, outputs, g_params, g_dummy)
