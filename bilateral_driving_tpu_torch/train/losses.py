"""The trainers' losses: port of bilateral_driving_tpu/train/losses.py
(L1, SSIM, the sky-opacity BCEs, the lidar depth loss in every form the
YAMLs set, opacity entropy, inverse-depth smoothness) and PSNR.

SSIM is the 11-tap separable Gaussian window applied as two banded matrix
products, with the window shrunk to the image where the image is smaller,
as the JAX package computes it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def l1(pred, gt):
    return torch.mean(torch.abs(pred - gt))


def masked_mean(x, mask, eps: float = 1.0):
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=eps)


@functools.lru_cache()
def _ssim_band_np(n: int, size: int = 11, sigma: float = 1.5):
    """(n - size + 1, n) banded Toeplitz matrix applying the 1-D Gaussian
    window as a valid convolution."""
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype("float32")
    m = n - size + 1
    A = np.zeros((m, n), "float32")
    for i in range(size):
        A[np.arange(m), np.arange(m) + i] = g[i]
    return A


def _filter2d(img, size: int = 11, sigma: float = 1.5):
    """img (H, W, C): separable Gaussian window, valid extent; images
    smaller than the window shrink it to the image."""
    h, w = img.shape[:2]
    size = min(size, h, w)
    ah, aw = (torch.from_numpy(_ssim_band_np(n, size, sigma)).to(
        device=img.device, dtype=img.dtype) for n in (h, w))
    out = torch.einsum("ih,hwc->iwc", ah, img)
    return torch.einsum("jw,iwc->ijc", aw, out)


def ssim(pred, gt, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2):
    """Mean SSIM of an (H, W, C) image pair in [0, 1]."""
    mu_x = _filter2d(pred)
    mu_y = _filter2d(gt)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x = _filter2d(pred * pred) - mu_xx
    sigma_y = _filter2d(gt * gt) - mu_yy
    sigma_xy = _filter2d(pred * gt) - mu_xy
    s = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2))
    return torch.mean(s)


class _SafeBCE(torch.autograd.Function):
    """Clipped BCE whose gradient is kept where the value saturates: x is
    clipped away from the saturating end, and the gradient is zero only
    where x == y exactly."""

    @staticmethod
    def forward(ctx, x, y, limit: float):
        ctx.save_for_backward(x, y)
        ctx.limit = limit
        xc = torch.clamp(x, 0.0, 1.0)
        log_limit = torch.log(torch.tensor(limit, dtype=x.dtype,
                                           device=x.device))
        return -torch.where(
            y == 0,
            torch.maximum(torch.log1p(-torch.clamp(xc, max=1.0 - 1e-12)),
                          log_limit),
            torch.maximum(torch.log(torch.clamp(xc, min=1e-12)), log_limit))

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        limit = ctx.limit
        xc = torch.where(y == 0, torch.clamp(x, 0.0, 1.0 - limit),
                         torch.clamp(x, limit, 1.0))
        gx = torch.where(y == 0, 1.0 / (1.0 - xc), -1.0 / xc) * g * (x != y)
        return gx, None, None


def safe_bce(pred, target, limit: float = 0.1):
    """The flagship's sky-opacity loss (`mask_loss_type` safe_bce)."""
    return torch.mean(_SafeBCE.apply(pred, torch.clamp(target, 0.0, 1.0),
                                     limit))


def bce(pred, target, eps: float = 1e-6):
    """Plain binary cross-entropy on probabilities (`mask_loss_type`
    bce)."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    return torch.mean(-(target * torch.log(p)
                        + (1.0 - target) * torch.log1p(-p)))


def depth_loss(pred, gt, hit_mask=None, loss_type: str = "l1",
               normalize: bool = False, use_inverse_depth: bool = False,
               max_depth: float = 80.0, reduction: str = "mean_on_hit"):
    """Lidar depth loss (losses.py:91-176 DepthLoss): l1, l2 or smooth l1,
    optionally on depths normalized by max_depth and/or inverted, over the
    valid hits; reduced as a mean over the hits, a mean over the image
    (mean_on_hw), a sum, or not at all."""
    pred = pred.reshape(gt.shape)
    if hit_mask is not None:
        pred = pred * hit_mask
        gt = gt * hit_mask
    valid = ((gt > 0.01) & (gt < max_depth) & (pred > 1e-4)).to(pred.dtype)
    if normalize:
        pred = torch.clamp(pred / max_depth, 1e-6, 1.0)
        gt = torch.clamp(gt / max_depth, 1e-6, 1.0)
    if use_inverse_depth:
        # a pixel left out (no hit, or nothing rendered) has depth 0 and
        # would invert to inf; the JAX package multiplies its NaN error by
        # 0, which keeps the value but gives the depth a NaN gradient.
        # Here it inverts 1 and gets 0 of both, the same wherever the JAX
        # package's gradient is finite (a port-only guard)
        pred = 1.0 / torch.where(valid > 0, pred, torch.ones_like(pred))
        gt = 1.0 / torch.where(valid > 0, gt, torch.ones_like(gt))
    if loss_type == "l1":
        err = torch.abs(pred - gt)
    elif loss_type == "l2":
        err = (pred - gt) ** 2
    elif loss_type == "smooth_l1":
        d = torch.abs(pred - gt)
        err = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    else:
        raise ValueError(loss_type)
    err = err * valid
    if reduction == "mean_on_hit":
        return masked_mean(err, valid)
    if reduction == "mean_on_hw":
        return torch.sum(err) / (gt.shape[0] * gt.shape[1])
    if reduction == "sum":
        return torch.sum(err)
    return err


def opacity_entropy(opacity):
    """-o log o regularizer (base.py:569-575)."""
    o = torch.clamp(opacity, 1e-6, 1.0 - 1e-6)
    return torch.mean(-o * torch.log(o))


def inverse_depth_smoothness(inv_depth, image):
    """kornia.losses.inverse_depth_smoothness_loss (base.py:576-585):
    edge-aware first-order smoothness; inv_depth (H, W), image (H, W, 3)."""
    didx = torch.abs(inv_depth[:, 1:] - inv_depth[:, :-1])
    didy = torch.abs(inv_depth[1:, :] - inv_depth[:-1, :])
    wx = torch.exp(-torch.mean(torch.abs(image[:, 1:] - image[:, :-1]),
                               dim=-1))
    wy = torch.exp(-torch.mean(torch.abs(image[1:, :] - image[:-1, :]),
                               dim=-1))
    return torch.mean(didx * wx) + torch.mean(didy * wy)


def psnr(pred, gt):
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
