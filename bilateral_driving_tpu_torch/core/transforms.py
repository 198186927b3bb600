"""Rotation math on tensors: port of bilateral_driving_tpu/core/transforms.py
(the functions the render path, the SMPL bodies and camera refinement use,
and the JAX package's public helpers none of them calls: the 6D encoding
of a rotation, homogeneous point transforms, the SE(3) inverse and pose
interpolation).

Quaternions are (w, x, y, z). Every function broadcasts over leading batch
dimensions and stays finite at the origin, in both passes.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True,
              eps: float = _EPS) -> torch.Tensor:
    """L2 norm with a finite gradient at x = 0: the squared norm is clamped
    before the sqrt, so below eps the gradient is exactly 0 (a clamp after
    `norm` routes 0 * NaN into the backward)."""
    sq = torch.clamp(torch.sum(x * x, dim=dim, keepdim=keepdim),
                     min=eps * eps)
    return torch.sqrt(sq)


def safe_normalize(x: torch.Tensor, dim: int = -1,
                   eps: float = _EPS) -> torch.Tensor:
    """x / ||x|| with a finite gradient at x = 0 (see safe_norm)."""
    sq = torch.clamp(torch.sum(x * x, dim=dim, keepdim=True), min=eps * eps)
    return x * torch.rsqrt(sq)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions, safe at q = 0."""
    return safe_normalize(q)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: float) -> torch.Tensor:
    """Shortest-arc slerp between unit quaternions at scalar t, with a lerp
    for nearly parallel pairs."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(torch.clamp(dot, -1.0, 1.0),
                                     0.0, 1.0 - 1e-7))
    sin_theta = torch.clamp(torch.sin(theta), min=_EPS)
    slerped = (torch.sin((1.0 - t) * theta) / sin_theta * q0
               + torch.sin(t * theta) / sin_theta * q1)
    lerped = (1.0 - t) * q0 + t * q1
    return quat_normalize(torch.where(dot > 0.9995, lerped, slerped))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion with w >= 0:
    the four Shepperd candidates, the best-conditioned one kept, as the
    JAX package computes it."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                         1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                        dim=-1)
    best = torch.argmax(cands, dim=-1)
    quats = torch.stack([qw, qx, qy, qz], dim=-2)     # (..., 4, 4)
    q = torch.gather(quats, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def axis_angle_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) by Rodrigues' formula, finite at
    aa = 0 in both passes."""
    theta = safe_norm(aa)
    x, y, z = safe_normalize(aa).unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                    dim=-1).reshape(aa.shape[:-1] + (3, 3))
    th = theta[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 4) wxyz quaternion, finite at aa = 0."""
    half = 0.5 * safe_norm(aa)
    return torch.cat([torch.cos(half), torch.sin(half) * safe_normalize(aa)],
                     dim=-1)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation (Zhou et al.) -> (..., 3, 3) matrix by
    Gram-Schmidt; the rows are the basis vectors."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = safe_normalize(a1)
    b2 = safe_normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows, which
    rotation_6d_to_matrix maps back to a rotation matrix."""
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def transform_points(matrix: torch.Tensor, points: torch.Tensor
                     ) -> torch.Tensor:
    """Apply a (..., 4, 4) homogeneous transform to (..., N, 3) points."""
    return (points @ matrix[..., :3, :3].transpose(-1, -2)
            + matrix[..., None, :3, 3])


def se3_compose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) and translation (..., 3) -> (..., 4, 4)."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(*R.shape[:-2], 1, 4)
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms: [R^T | -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_compose(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def interpolate_poses(T0: torch.Tensor, T1: torch.Tensor,
                      t: float) -> torch.Tensor:
    """(..., 4, 4) poses at scalar t between T0 and T1: the rotations
    slerped, the translations lerped."""
    q = quat_slerp(rotmat_to_quat(T0[..., :3, :3]),
                   rotmat_to_quat(T1[..., :3, :3]), t)
    tr = (1.0 - t) * T0[..., :3, 3] + t * T1[..., :3, 3]
    return se3_compose(quat_to_rotmat(q), tr)
