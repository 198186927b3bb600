"""Voxel skinning deformer: port of
bilateral_driving_tpu/scene/voxel_deformer.py.

Per SMPL instance a (J, D, H, W) voxel of linear-blend-skinning weights
over the canonical body's padded bounding box, initialised from the mesh
weights by an inverse-distance blend of the 30 nearest vertices and 30
Jacobi smoothing passes, plus a learnable correction (zero at init)
queried trilinearly; TV and magnitude regularisers of the correction.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.bilateral import grid_sample_3d

GLOBAL_SCALE = 1.2       # bounding-box padding
KNN_CHUNK = 4096         # grid points per distance block (4096 x V floats)


class VoxelDeformerStatics(NamedTuple):
    lbs_voxel_base: torch.Tensor   # (B, J, D, H, W)
    offset: torch.Tensor           # (B, 3)
    scale: torch.Tensor            # (B,)
    ratio: float                   # long / short resolution (z compressed)


def _normalize(x: torch.Tensor, statics: VoxelDeformerStatics):
    """Canonical points (B, N, 3) -> [-1, 1]^3 sampling coordinates, z (the
    short axis) scaled by `ratio`."""
    xn = (x - statics.offset[:, None]) / statics.scale[:, None, None]
    return torch.cat([xn[..., :2], xn[..., 2:] * statics.ratio], dim=-1)


def _linspace(n: int, dtype, device) -> torch.Tensor:
    """n points from -1 to 1 formed as the JAX package's jitted
    jnp.linspace forms them in float32: s = i * (1 / (n - 1)), then
    s - (1 - s), then the end point. torch.linspace rounds some points an
    ulp apart, which moves grid points across neighbour-distance ties."""
    s = torch.arange(n - 1, dtype=dtype, device=device) * (
        torch.ones((), dtype=dtype, device=device) / (n - 1))
    return torch.cat([s - (1 - s), torch.ones(1, dtype=dtype,
                                              device=device)])


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...,) x0^2 + x1^2 + x2^2 as XLA's CPU reduction forms
    it: a fused multiply-add per term after the first (each step rounded
    once, here through float64). With the plain sum the JAX package's
    float32 distances to the nearest vertices, which the inverse-distance
    weights amplify, come out further from the port's."""
    acc = x[..., 0] * x[..., 0]
    for i in (1, 2):
        xi = x[..., i].double()
        acc = (xi * xi + acc.double()).to(x.dtype)
    return acc


def _knn_blend(gpts: torch.Tensor, vts: torch.Tensor, wts: torch.Tensor,
               k: int) -> torch.Tensor:
    """(G, J) inverse-distance blend of the weights of each grid point's k
    nearest vertices. Squared distances |g|^2 - 2 g.v + |v|^2 in the
    points' dtype, as the JAX package forms them (so the neighbour sets
    agree), KNN_CHUNK grid points at a time."""
    sq_v = _sq_norm(vts)[None]
    out = []
    for g in gpts.split(KNN_CHUNK):
        d2 = _sq_norm(g)[:, None] - 2.0 * g @ vts.T + sq_v
        neg, idx = torch.topk(-d2, k, dim=-1)
        dist = torch.clamp(torch.sqrt(torch.clamp(-neg, min=0.0)), 1e-4, 1.0)
        ws = 1.0 / dist
        ws = ws / ws.sum(dim=-1, keepdim=True)
        out.append(torch.einsum("nk,nkj->nj", ws, wts[idx]))
    return torch.cat(out)


def init_voxel_deformer(verts: torch.Tensor, weights: torch.Tensor,
                        resolution_dhw=(16, 64, 64), knn_k: int = 30,
                        smooth_iters: int = 30):
    """verts (B, V, 3), weights (B, V, J) -> (statics, params): the grid's
    weights, the inverse-distance KNN blend of the mesh weights, then
    `smooth_iters` Jacobi passes over the interior (0.7 of a cell's own
    value off its six neighbours' mean), each renormalised over the
    joints; the correction `voxel_w_correction` starts at zero."""
    B = verts.shape[0]
    J = weights.shape[-1]
    d, h, w = resolution_dhw
    ratio = float(max(resolution_dhw)) / float(d)
    dt, dev = verts.dtype, verts.device

    bb_min = verts.amin(dim=1)
    bb_max = verts.amax(dim=1)
    offset = 0.5 * (bb_min + bb_max)
    scale = (bb_max - bb_min).amax(dim=-1) / 2.0 * GLOBAL_SCALE

    gz, gy, gx = torch.meshgrid(*(_linspace(n, dt, dev) for n in (d, h, w)),
                                indexing="ij")
    grid = torch.stack([gx, gy, gz / ratio], dim=-1).reshape(-1, 3)
    vox = torch.stack([
        _knn_blend(grid * scale[b] + offset[b], verts[b], weights[b], knn_k)
        for b in range(B)])                               # (B, DHW, J)
    vox = vox.transpose(1, 2).reshape(B, J, d, h, w)

    for _ in range(smooth_iters):
        mean = (vox[:, :, 2:, 1:-1, 1:-1] + vox[:, :, :-2, 1:-1, 1:-1]
                + vox[:, :, 1:-1, 2:, 1:-1] + vox[:, :, 1:-1, :-2, 1:-1]
                + vox[:, :, 1:-1, 1:-1, 2:] + vox[:, :, 1:-1, 1:-1, :-2]
                ) / 6.0
        vox = vox.clone()
        vox[:, :, 1:-1, 1:-1, 1:-1] = \
            (vox[:, :, 1:-1, 1:-1, 1:-1] - mean) * 0.7 + mean
        vox = vox / vox.sum(dim=1, keepdim=True)

    statics = VoxelDeformerStatics(vox, offset, scale, ratio)
    return statics, {"voxel_w_correction": torch.zeros_like(vox)}


def query_weights(statics: VoxelDeformerStatics, params,
                  xc: torch.Tensor) -> torch.Tensor:
    """Trilinear query of base + correction at canonical points xc
    (B, N, 3) -> (B, N, J)."""
    vol = statics.lbs_voxel_base + params["voxel_w_correction"]
    coords = _normalize(xc, statics)
    return torch.stack([grid_sample_3d(vol[b], coords[b])
                        for b in range(vol.shape[0])])


def tv_loss(params) -> torch.Tensor:
    """Mean absolute difference of the correction along D, H and W."""
    d = params["voxel_w_correction"]
    return (torch.diff(d, dim=2).abs().mean()
            + torch.diff(d, dim=3).abs().mean()
            + torch.diff(d, dim=4).abs().mean()) / 3.0


def mag_loss(params) -> torch.Tensor:
    """Mean over cells of the correction's norm over the joints."""
    return torch.linalg.vector_norm(params["voxel_w_correction"],
                                    dim=1).mean()
