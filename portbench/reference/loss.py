"""The 3DGS training objective: (1 - l) L1 + l (1 - SSIM), l = 0.2.

SSIM with the standard 11x11 Gaussian window (sigma 1.5), separable, each
1-D pass as shifted multiply-adds over a zero-padded image.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

WINDOW, SIGMA = 11, 1.5
_X = [i - (WINDOW - 1) / 2.0 for i in range(WINDOW)]
_G = [math.exp(-(x * x) / (2 * SIGMA * SIGMA)) for x in _X]
WEIGHTS = [g / sum(_G) for g in _G]


def _conv1d(x, axis):
    half = WINDOW // 2
    pad = [0, 0, 0, 0]
    pad[2 * (x.ndim - 1 - axis):2 * (x.ndim - axis)] = [half, half]
    xp = F.pad(x, pad)
    out = 0.0
    for k in range(WINDOW):
        out = out + WEIGHTS[k] * xp.narrow(axis, k, x.shape[axis])
    return out


def ssim(pred, target):
    c1, c2 = 0.01 ** 2, 0.03 ** 2

    def conv(x):
        return _conv1d(_conv1d(x, 1), 2)

    mu_p, mu_t = conv(pred), conv(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_p = conv(pred * pred) - mu_pp
    sigma_t = conv(target * target) - mu_tt
    sigma_pt = conv(pred * target) - mu_pt
    return torch.mean(((2 * mu_pt + c1) * (2 * sigma_pt + c2))
                      / ((mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2)))


def rgb_loss(pred, target, lambda_dssim: float):
    return ((1.0 - lambda_dssim) * torch.mean(torch.abs(pred - target))
            + lambda_dssim * (1.0 - ssim(pred, target)))
