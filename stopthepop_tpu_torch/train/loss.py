"""3DGS training losses: L1 + D-SSIM (the upstream trainer's objective).

Port of ``stopthepop_tpu/train/loss.py``:
loss = (1 - lambda_dssim) * L1 + lambda_dssim * (1 - SSIM), lambda_dssim=0.2.
SSIM uses the standard 11x11 Gaussian window (sigma=1.5), separable, each 1D
pass as K shifted multiply-adds over a zero-padded image ("SAME" padding), in
the JAX package's order. No convolution is involved, so cuDNN's TF32 setting
does not touch it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5):
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def ssim(pred, target, window_size: int = 11):
    """SSIM over [C, H, W] images (mean over channels and pixels)."""
    c1, c2 = 0.01**2, 0.03**2
    w1d = _gaussian_kernel1d(window_size)
    half = window_size // 2

    def conv1d(x, axis):
        pad = [0, 0, 0, 0]  # F.pad lists the last axis first
        pad[2 * (x.ndim - 1 - axis):2 * (x.ndim - axis)] = [half, half]
        xp = F.pad(x, pad)
        n = x.shape[axis]
        out = 0.0
        for k in range(window_size):
            out = out + float(w1d[k]) * xp.narrow(axis, k, n)
        return out

    def conv(x):
        return conv1d(conv1d(x, 1), 2)

    mu_p = conv(pred)
    mu_t = conv(target)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sigma_p = conv(pred * pred) - mu_pp
    sigma_t = conv(target * target) - mu_tt
    sigma_pt = conv(pred * target) - mu_pt
    ssim_map = ((2 * mu_pt + c1) * (2 * sigma_pt + c2)) / (
        (mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2)
    )
    return torch.mean(ssim_map)


def rgb_loss(pred, target, lambda_dssim: float = 0.2):
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * (
        1.0 - ssim(pred, target)
    )


def psnr(pred, target):
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
