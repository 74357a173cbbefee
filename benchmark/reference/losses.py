"""The reference's image losses (GaussianHaircut's ``utils/loss_utils.py``):
masked L1, the wrapped-angle orientation loss with its confidence term, and
SSIM with an 11x11 Gaussian window of sigma 1.5 as the original computes it
(a depthwise convolution with zero padding)."""
from __future__ import annotations

import math

import torch

from reference import precision as prec


def l1(pred, gt, mask=None):
    loss = torch.abs(pred - gt)
    if mask is not None:
        loss = loss * mask
    return torch.mean(loss)


def orientation(pred, gt, confs, weight, mask):
    """Angles in [0, 1] ~ [0, pi), the difference wrapped, times pi, with the
    aleatoric confidence term, weighted and normalised by the weight."""
    d = pred - gt
    loss = torch.minimum(torch.abs(d), torch.minimum(torch.abs(d - 1.0), torch.abs(d + 1.0)))
    loss = loss * math.pi
    if confs is not None:
        loss = loss * confs - torch.log(confs + 1e-7)
    loss = loss * mask
    return torch.sum(loss * weight) / torch.sum(weight)


def _window(device, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-xs ** 2 / (2 * sigma ** 2))
    g = (g / g.sum()).to(torch.float32)
    return (g[:, None] * g[None, :]).to(device)


def ssim(img1, img2):
    """Mean SSIM of two [C, H, W] images."""
    c = img1.shape[0]
    win = _window(img1.device).expand(c, 1, 11, 11).contiguous()
    blur = lambda x: prec.conv2d(x[None], win, padding=5, groups=c)[0]
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(m)


def zero_nan(x):
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)
