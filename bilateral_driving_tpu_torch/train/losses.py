"""The flagship's losses: port of the parts of
bilateral_driving_tpu/train/losses.py that omnire_ms_bilateral reads (L1,
SSIM, the sky-opacity BCEs, the lidar depth loss) and PSNR.

SSIM is the 11-tap separable Gaussian window applied as two banded matrix
products, with the window shrunk to the image where the image is smaller,
as the JAX package computes it. Other losses wait for the slice whose
configuration weights them.
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
    """Lidar depth loss; the flagship takes l1, unnormalized, direct depth,
    mean over the valid hits."""
    if (loss_type != "l1" or normalize or use_inverse_depth
            or reduction != "mean_on_hit"):
        raise NotImplementedError(
            "depth_loss: only the flagship's l1 / mean_on_hit form is ported "
            "yet: the loss-variants slice")
    pred = pred.reshape(gt.shape)
    if hit_mask is not None:
        pred = pred * hit_mask
        gt = gt * hit_mask
    valid = ((gt > 0.01) & (gt < max_depth) & (pred > 1e-4)).to(pred.dtype)
    err = torch.abs(pred - gt) * valid
    return masked_mean(err, valid)


def psnr(pred, gt):
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
