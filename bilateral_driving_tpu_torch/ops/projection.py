"""3D -> 2D Gaussian projection (EWA splatting): port of
bilateral_driving_tpu/ops/projection.py, in the same component form and
operation order.

gsplat v1.3.0 semantics: frustum-clamped perspective Jacobian with
lim = 1.3 tan(fov/2); eps2d = 0.3 pixel blur on the 2D covariance diagonal;
antialiased mode scales opacity by sqrt(det(cov2d) / det(cov2d + eps2d I));
radius = ceil(3 sqrt(max eigenvalue)), culled at or below radius_clip, off
the image, or outside (near, far).

One guard is the port's own: a Gaussian whose blurred 2D covariance has a
non-finite determinant (an overflowed scale, a non-finite mean) is culled
and its inputs get zero gradients. The JAX package culls a NaN determinant
too (`det > 0` is false) but lets its gradient through, where the conic's
VJP multiplies a zero cotangent by NaN and poisons every leaf of the
class; everywhere the determinant is finite the two are the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

EPS2D = 0.3


class Projected(NamedTuple):
    means2d: torch.Tensor        # (N, 2) pixel coordinates
    conics: torch.Tensor         # (N, 3) a, b, c of the inverse 2D covariance
    depths: torch.Tensor         # (N,) camera-space z
    radii: torch.Tensor          # (N,) int32 pixel radii, 0 if culled
    compensations: torch.Tensor  # (N,) antialiasing opacity factor
    valid: torch.Tensor          # (N,) bool


def project(means, quats, scales, viewmat, K, width: int, height: int, *,
            near_plane: float = 0.01, far_plane: float = 1e10,
            radius_clip: float = 0.0, antialiased: bool = False,
            eps2d: float = EPS2D, fov_extent: tuple | None = None,
            row_offset: int = 0, cull_rows: tuple | None = None
            ) -> Projected:
    """Rendering a band of a larger image (tile bands): `fov_extent`, the
    full image's (width, height), sets the field of view of the Jacobian's
    frustum clamp (None: the render's own extent), `row_offset`, the
    band's first row, is subtracted from the projected means after the
    principal point is added, so they are exactly the full image's less
    it and the bands stitch without seams, and `cull_rows`, the rows
    (first, end) a Gaussian must reach to stay valid, in the render's
    coordinates (None: (0, height)), lets a band keep the full image's
    Gaussians, radii and valid flags."""
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    mean_c = means @ R.T + t
    z = mean_c[..., 2]

    q = quats / torch.sqrt(torch.clamp(
        torch.sum(quats * quats, dim=-1, keepdim=True), min=1e-16))
    qw, qx, qy, qz = q.unbind(-1)
    r = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ]
    s3 = scales.unbind(-1)
    # M = R_cam (R_q S)
    M = [[sum(R[i, k] * r[k][j] for k in range(3)) * s3[j]
          for j in range(3)] for i in range(3)]

    def covc(i, j):
        return sum(M[i][k] * M[j][k] for k in range(3))

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    # all projection math uses z clamped to the near plane: z ~ 0 overflows
    # a * c and gives NaN; culled Gaussians just get finite bogus values
    zs = torch.clamp(z, min=near_plane)
    rz = 1.0 / zs

    fov_w, fov_h = fov_extent if fov_extent is not None else (width, height)
    lim_x = 1.3 * (0.5 * fov_w / fx)
    lim_y = 1.3 * (0.5 * fov_h / fy)
    tx = zs * torch.clamp(mean_c[..., 0] * rz, -lim_x, lim_x)
    ty = zs * torch.clamp(mean_c[..., 1] * rz, -lim_y, lim_y)

    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2

    c00, c01, c02 = covc(0, 0), covc(0, 1), covc(0, 2)
    c11, c12, c22 = covc(1, 1), covc(1, 2), covc(2, 2)
    a = j00 * j00 * c00 + 2.0 * j00 * j02 * c02 + j02 * j02 * c22
    b = j00 * j11 * c01 + j00 * j12 * c02 + j02 * j11 * c12 + j02 * j12 * c22
    c = j11 * j11 * c11 + 2.0 * j11 * j12 * c12 + j12 * j12 * c22

    det_orig = a * c - b * b
    a_bl = a + eps2d
    c_bl = c + eps2d
    det = a_bl * c_bl - b * b
    det_safe = torch.where(det <= 0.0, torch.ones_like(det), det)

    if antialiased:
        compensations = torch.sqrt(torch.clamp(det_orig / det_safe, min=0.0))
    else:
        compensations = torch.ones_like(det)

    inv_det = 1.0 / det_safe
    conic = torch.stack([c_bl * inv_det, -b * inv_det, a_bl * inv_det],
                        dim=-1)

    b_mid = 0.5 * (a_bl + c_bl)
    disc = torch.sqrt(torch.clamp(b_mid * b_mid - det, min=0.01))
    v1 = b_mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(v1, min=0.0)))

    my = fy * mean_c[..., 1] * rz + cy
    if row_offset:
        my = my - row_offset
    means2d = torch.stack([fx * mean_c[..., 0] * rz + cx, my], dim=-1)

    finite = torch.isfinite(det)
    for x in (means, quats, scales):
        if x.requires_grad:
            x.register_hook(lambda g: torch.where(finite[:, None], g,
                                                  torch.zeros_like(g)))
    row0, row1 = cull_rows if cull_rows is not None else (0, height)
    valid = ((z > near_plane) & (z < far_plane) & (det > 0.0) & finite
             & (radius > radius_clip)
             & (means2d[..., 0] + radius > 0)
             & (means2d[..., 0] - radius < width)
             & (means2d[..., 1] + radius > row0)
             & (means2d[..., 1] - radius < row1))
    radii = torch.where(valid, radius, torch.zeros_like(radius)).to(
        torch.int32)
    return Projected(means2d, conic, z, radii, compensations, valid)
