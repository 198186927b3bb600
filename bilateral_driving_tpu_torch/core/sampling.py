"""Point sampling helpers: port of bilateral_driving_tpu/core/sampling.py.

`knn_mean_distance` gives the scale initialisation of point-cloud classes
(train/setup.knn_scales). It keeps the JAX package's blocked streaming
k-best: query chunks against reference blocks with a running merge, the
same squared-distance formula, and above `max_reference` points a strided
subsample as the reference set. That formula, |q|^2 - 2 q.r + |r|^2 in
float32, cancels for points far from the origin: a distance d comes out
within about 4 eps (|q|^2 + |r|^2) / d of the exact one, in either package.
"""
from __future__ import annotations

import torch


def uniform_sample_sphere(generator: torch.Generator, n: int,
                          radius_min: float, radius_max: float,
                          device=None) -> torch.Tensor:
    """(n, 3) points uniform in volume in the shell [radius_min,
    radius_max), drawn from `generator`."""
    device = generator.device if device is None else device
    dirs = torch.randn((n, 3), generator=generator, device=generator.device)
    dirs = dirs * torch.rsqrt(torch.clamp(
        torch.sum(dirs * dirs, dim=-1, keepdim=True), min=1e-16))
    u = torch.rand((n, 1), generator=generator, device=generator.device)
    r = (u * (radius_max ** 3 - radius_min ** 3)
         + radius_min ** 3) ** (1.0 / 3.0)
    return (dirs * r).to(device)


def knn_mean_distance(points: torch.Tensor, k: int = 3, chunk: int = 1024,
                      ref_block: int = 4096,
                      max_reference: int = 100_000) -> torch.Tensor:
    """(N,) mean distance of each point to its k nearest neighbours (the
    nearest of k + 1 candidates, the point itself, dropped). `topk` runs
    over one reference block plus the running k + 1 best, never over the
    whole set. With k or fewer reference points the mean is over the
    others (one point: 0), where the JAX package's is inf: a class of three
    lidar points, e.g. a far bicycle, would start with infinite scales."""
    n = points.shape[0]
    ref = points[::-(-n // max_reference)] if n > max_reference else points
    k = min(k, ref.shape[0] - 1)
    if k < 1:
        return torch.zeros(n, dtype=points.dtype, device=points.device)
    blocks = []
    for lo in range(0, ref.shape[0], ref_block):
        rb = ref[lo:lo + ref_block]
        blocks.append((rb.T.contiguous(), torch.sum(rb * rb, dim=-1)))
    out = []
    for lo in range(0, n, chunk):
        q = points[lo:lo + chunk]
        qsq = torch.sum(q * q, dim=-1, keepdim=True)
        best = torch.full((q.shape[0], k + 1), -torch.inf,
                          device=points.device)
        for rt, rsq in blocks:
            d2 = qsq - (2.0 * q) @ rt + rsq[None, :]
            cand = torch.topk(-d2, min(k + 1, d2.shape[1]), dim=1).values
            best = torch.topk(torch.cat([best, cand], dim=1), k + 1,
                              dim=1).values
        d = torch.sqrt(torch.clamp(-best[:, 1:], min=0.0))
        out.append(torch.mean(d, dim=-1))
    return torch.cat(out)
