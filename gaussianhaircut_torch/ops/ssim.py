"""SSIM with an 11x11 sigma-1.5 Gaussian window (port of
``gaussianhaircut_tpu/ops/ssim.py``; reference loss_utils.py:81-121).

The separable blur is two band-matrix products (one per image axis); the
truncated rows of the band matrix are F.conv2d's zero padding.  The products
run in full float32: the package turns TF32 off (``__init__.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, window_size: int, sigma: float,
                 device: torch.device) -> torch.Tensor:
    """[n, n] banded blur matrix on ``device``: B[i, j] = win[j - i + w//2].
    Cached, so a training loop copies it to the card once (callers never
    write to it)."""
    win = _gaussian_window(window_size, sigma)
    half = window_size // 2
    b = np.zeros((n, n), np.float32)
    for k in range(-half, half + 1):
        b += np.diag(np.full(n - abs(k), win[k + half], np.float32), k)
    return torch.from_numpy(b).to(device)


def _blur(img: torch.Tensor, window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    _, h, w = img.shape
    bh = _band_matrix(h, window_size, sigma, img.device)
    bw = _band_matrix(w, window_size, sigma, img.device)
    x = torch.einsum("chw,hk->ckw", img, bh)
    return torch.einsum("ckw,wj->ckj", x, bw)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over [C, H, W] images in [0, 1]."""
    mu1 = _blur(img1, window_size)
    mu2 = _blur(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)
