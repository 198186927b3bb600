"""Carry a scene from the JAX package's structures into the port's.

The JAX trainer keeps `params`, `statics`, `aux` and `masks` as nested dicts
and lists of arrays; the port keeps the same nesting with tensors, except
that a deformation network (`deform_net`: trunk/heads dicts of (in, out)
weight matrices) becomes a models.deform.DeformNetwork and an SMPL
template (a NamedTuple whose `parents` is wrapped in a static holder)
becomes a scene.smpl_model.SMPLTemplate with `parents` a plain tuple.
Inputs are numpy arrays (np.asarray of the JAX leaves); nothing of JAX is
imported here. `train_state_from_jax` carries a training state: parameters,
aux, masks, density statistics and step; the port builds its own fresh
Adam state. It takes the synthetic states of the JAX package and those its
tools/common.build_real_scene builds from a scene directory: SMPLNodes
(template, instances_fv, nn_ind, on_mesh_x, point_ids, the pose tracks)
when SMPL is on, the pedestrians in DeformableNodes when it is off, and
every appearance model's Affine (the grids, the affine codes' embedding
and decoder, the neural grids' MLP heads, the CP-4D factor banks), the
camera refinements CamPose and CamPosePerturb, a PVG Background's taus,
log betas and velocities, and a DeformableGS Background's network (its
`deform_net`, a DeformNetwork without instance codes) with the
contraction box in its statics, and the voxel skinning deformer's
statics (a VoxelDeformerStatics whose `ratio` stays a float). An MLP's
static `skips` leaf is dropped: the port's callers pass the skips to
encoders.mlp_apply themselves (the sky head's (1,) among them). `synthetic_scene_from_jax` carries the JAX
package's generated scene (data/synthetic.SyntheticScene: one camera, one
rigid instance) into the port's SyntheticScene, so that
tools/common.build_synthetic_scene builds from the same points.
"""
from __future__ import annotations

import numpy as np
import torch

from .data import synthetic
from .models.deform import DeformNetwork
from .scene import smpl_model, voxel_deformer
from .train import density, trainer


def _meta(meta) -> dict:
    """The static metadata of a JAX deform net (an object holding a dict in
    `.value`, or the dict itself)."""
    return getattr(meta, "value", meta)


def deform_net_from_jax(tree, device) -> DeformNetwork:
    meta = _meta(tree["meta"])
    trunk, heads = tree["trunk"], tree["heads"]
    x_dim = 3 * (1 + 2 * meta["x_multires"])
    t_dim = 1 + 2 * meta["t_multires"]
    in_dim = np.asarray(trunk[0]["w"]).shape[0]
    net = DeformNetwork(
        depth=len(trunk), width=np.asarray(trunk[0]["w"]).shape[1],
        embed_dim=in_dim - x_dim - t_dim, x_multires=meta["x_multires"],
        t_multires=meta["t_multires"], deform_quat="quat" in heads,
        deform_scale="scale" in heads)
    if tuple(meta["skips"]) != net.skips:
        raise ValueError(f"deform net skips {meta['skips']} != {net.skips}")
    net = net.to(torch.from_numpy(np.array(trunk[0]["w"])).dtype)
    with torch.no_grad():
        for lin, layer in zip([*net.trunk, *(net.heads[k] for k in net.heads)],
                              [*trunk, *(heads[k] for k in net.heads)]):
            lin.weight.copy_(torch.from_numpy(np.array(layer["w"]).T))
            lin.bias.copy_(torch.from_numpy(np.array(layer["b"])))
    # like every converted leaf, frozen until trainer.init_state
    return net.to(device).requires_grad_(False)


def _parents(parents) -> tuple:
    return tuple(int(i) for i in _meta(parents))


def smpl_template_from_jax(template, device) -> smpl_model.SMPLTemplate:
    t = lambda x: torch.from_numpy(np.array(x)).to(device)
    return smpl_model.SMPLTemplate(
        t(template.j_canonical), t(template.a0_inv),
        t(template.verts_canonical), t(template.lbs_weights),
        _parents(template.parents))


def smpl_model_from_jax(model, device) -> smpl_model.SMPLModel:
    t = lambda x: torch.from_numpy(np.array(x)).to(device)
    return smpl_model.SMPLModel(
        t(model.v_template), t(model.shapedirs), t(model.j_regressor),
        t(model.lbs_weights), _parents(model.parents),
        np.asarray(model.faces, np.int64))


def _is_static(x) -> bool:
    """A JAX static holder (metadata in `.value`, not an array)."""
    return hasattr(x, "value") and not hasattr(x, "shape")


def voxel_statics_from_jax(st, device):
    t = lambda x: torch.from_numpy(np.array(x)).to(device)
    return voxel_deformer.VoxelDeformerStatics(
        t(st.lbs_voxel_base), t(st.offset), t(st.scale), float(st.ratio))


def tree_from_jax(tree, device):
    """Dicts and lists recurse, arrays become tensors of the same dtype,
    static leaves (an MLP's `skips`) are dropped."""
    if hasattr(tree, "a0_inv"):
        return smpl_template_from_jax(tree, device)
    if hasattr(tree, "lbs_voxel_base"):
        return voxel_statics_from_jax(tree, device)
    if isinstance(tree, dict):
        return {k: (deform_net_from_jax(v, device) if k == "deform_net"
                    else tree_from_jax(v, device)) for k, v in tree.items()
                if not _is_static(v)}
    if isinstance(tree, (list, tuple)):
        return [tree_from_jax(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def scene_from_jax(params, statics, aux, masks, device="cuda"):
    """(params, statics, aux, masks) of the JAX trainer -> the port's."""
    return tuple(tree_from_jax(t, device)
                 for t in (params, statics, aux, masks))


def train_state_from_jax(cfg, params, aux, masks, stats, step: int,
                         device="cuda", generator=None):
    """A port TrainerState from the fields of a JAX TrainerState (stats:
    class name -> DensityStats of arrays). The optimizer is fresh, as a
    JAX state with a fresh opt_state is."""
    tparams, taux, tmasks = (tree_from_jax(t, device)
                             for t in (params, aux, masks))
    state = trainer.init_state(cfg, tparams, tmasks, taux, step=int(step),
                               generator=generator)
    state.stats = {name: density.DensityStats(*(
        torch.from_numpy(np.array(x)).to(device) for x in s))
        for name, s in stats.items()}
    return state


def synthetic_scene_from_jax(scene, device="cuda") -> synthetic.SyntheticScene:
    """The JAX package's SyntheticScene (arrays as numpy) as the port's:
    its rigid instance under inst["RigidNodes"], its per-frame cameras one
    image each."""
    t = lambda x: torch.from_numpy(np.array(x)).to(device)
    car = {"means": t(scene.rigid_means), "colors": t(scene.rigid_colors),
           "point_ids": t(scene.rigid_point_ids),
           "quats": t(scene.rigid_quats), "trans": t(scene.rigid_trans),
           "frame_valid": t(scene.rigid_fv), "sizes": t(scene.rigid_sizes)}
    return synthetic.SyntheticScene(
        t(scene.bg_means), t(scene.bg_colors), {"RigidNodes": car},
        t(scene.cameras), t(scene.K), int(scene.width), int(scene.height),
        int(scene.num_frames), 1)


def segformer_params_from_hf(state) -> dict:
    """transformers' SegformerForSemanticSegmentation state dict, its
    leaves as numpy arrays, as the state dict of the port's
    models/segformer.SegformerForSemanticSegmentation: the port keeps
    transformers' parameter names (segformer.encoder.*, decode_head.*,
    with the batch norm's running statistics), so each leaf becomes a
    tensor under its own name. A name outside those two trees (another
    head, an older naming) raises."""
    out = {}
    for name, leaf in state.items():
        if not name.startswith(("segformer.encoder.", "decode_head.")):
            raise ValueError(f"{name}: not a parameter of "
                             "SegformerForSemanticSegmentation")
        out[name] = torch.from_numpy(np.array(leaf))
    return out
