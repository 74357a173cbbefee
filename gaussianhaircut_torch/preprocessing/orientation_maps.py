"""Gabor orientation maps: per-pixel strand orientation and its circular
variance (port of ``gaussianhaircut_tpu/preprocessing/orientation_maps.py``;
reference src/preprocessing/calc_orientation_maps.py:24-97).

Per image:
1. gray -> difference-of-Gaussians band-pass (5 and 81 taps), padded
   "symmetric" (numpy's mode: the edge sample repeated, then mirrored,
   periodic over 2n however wide the pad);
2. a bank of 180 real Gabor filters (17x17), one ``conv2d``: a
   cross-correlation, as ``lax.conv``, with zero padding;
3. orientation = argmax over the filters of |response| (the first index on
   a tie, as ``jnp.argmax``); circular variance = sum over theta of
   d(theta, argmax)^2 x |response| normalised to sum 1.

The JAX package maps 128-row bands to bound its [180, H, W] response; the
port takes the whole image at once (at 960x544 the response is 376 MB on
the card).  Runs on CUDA unless given ``device="cpu"``; TF32 stays off
(the package's ``__init__``).  Outputs keep the reference's files: angle
PNGs in integer degrees [0, 180), variance ``.npy`` float16.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from gaussianhaircut_torch.device import resolve_device


def gabor_kernel_real(frequency: float, theta: float, sigma_x: float,
                      sigma_y: float, offset: float = 0.0,
                      nstds: float = 3.0) -> np.ndarray:
    """Real part of a complex Gabor kernel, skimage's conventions (rotated
    Gaussian envelope x sinusoid along x_theta, over 2 pi sigma_x sigma_y)."""
    x0 = math.ceil(max(abs(nstds * sigma_x * math.cos(theta)),
                       abs(nstds * sigma_y * math.sin(theta)), 1))
    y0 = math.ceil(max(abs(nstds * sigma_y * math.cos(theta)),
                       abs(nstds * sigma_x * math.sin(theta)), 1))
    y, x = np.mgrid[-y0:y0 + 1, -x0:x0 + 1]
    rotx = x * math.cos(theta) + y * math.sin(theta)
    roty = -x * math.sin(theta) + y * math.cos(theta)
    g = np.exp(-0.5 * (rotx ** 2 / sigma_x ** 2 + roty ** 2 / sigma_y ** 2))
    g /= 2 * math.pi * sigma_x * sigma_y
    return (g * np.cos(2 * math.pi * frequency * rotx + offset)).astype(np.float32)


def build_gabor_bank(num_filters: int = 180, sigma_x: float = 1.8,
                     sigma_y: float = 2.4, frequency: float = 0.23,
                     offset: float = 0.0):
    """[(F, k, k) filter stack zero-padded to a common odd size, thetas [F]];
    theta_i mirrored (pi - theta) as the reference's bank
    (calc_orientation_maps.py:37)."""
    thetas = np.linspace(0, math.pi * (num_filters - 1) / num_filters, num_filters)
    kernels = [gabor_kernel_real(frequency, math.pi - t, sigma_x, sigma_y, offset)
               for t in thetas]
    size = max(max(k.shape) for k in kernels)
    size += 1 - size % 2
    bank = np.zeros((num_filters, size, size), np.float32)
    for i, k in enumerate(kernels):
        py = (size - k.shape[0]) // 2
        px = (size - k.shape[1]) // 2
        bank[i, py:py + k.shape[0], px:px + k.shape[1]] = k
    return bank, thetas.astype(np.float32)


def _gaussian_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    r = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-r, r + 1)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def symmetric_index(n: int, pad: int) -> np.ndarray:
    """Source indices of ``np.pad(x, pad, mode="symmetric")`` along an axis
    of length n, for any pad (numpy's pad repeats the mirror when the pad
    exceeds n): period 2n, the second half reversed."""
    j = np.mod(np.arange(-pad, n + pad), 2 * n)
    return np.where(j >= n, 2 * n - 1 - j, j)


def _sep_blur(img: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable blur of [H, W] with symmetric padding: the column pass,
    then the row pass, each a VALID correlation."""
    r = win.shape[0] // 2
    h, w = img.shape
    rows = torch.as_tensor(symmetric_index(h, r), device=img.device)
    cols = torch.as_tensor(symmetric_index(w, r), device=img.device)
    x = img[rows][:, cols][None, None]
    k = torch.as_tensor(win, device=img.device)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x[0, 0]


def difference_of_gaussians(gray: torch.Tensor, low_sigma: float,
                            high_sigma: float) -> torch.Tensor:
    return (_sep_blur(gray, _gaussian_1d(low_sigma))
            - _sep_blur(gray, _gaussian_1d(high_sigma)))


def gabor_responses(filtered: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """|response| [F, H, W] of the bank [F, k, k] over filtered [H, W]: a
    cross-correlation (no flip, as ``lax.conv``) with zero padding."""
    pad = bank.shape[-1] // 2
    return F.conv2d(filtered[None, None], bank[:, None], padding=pad)[0].abs()


def orients_from_filtered(filtered: torch.Tensor, bank: torch.Tensor,
                          thetas: torch.Tensor, num_filters: int):
    """filtered [H, W] -> (orientation index int64 [H, W] (degrees for 180
    filters), circular variance float32 [H, W]), the whole image at once."""
    resp = gabor_responses(filtered, bank)
    amax = torch.argmax(resp, dim=0)
    rad = amax.to(torch.float32) / num_filters * math.pi
    diff = rad[None] - thetas[:, None, None]
    d = torch.minimum(diff.abs(), torch.minimum((diff - math.pi).abs(),
                                                (diff + math.pi).abs()))
    del diff
    norm = resp / torch.clamp(resp.sum(dim=0, keepdim=True), min=1e-12)
    del resp
    return amax, (d * d * norm).sum(dim=0)


@torch.no_grad()
def calc_orientation_map(image_rgb: np.ndarray, dog_low: float = 0.4,
                         dog_high: float = 10.0, num_filters: int = 180,
                         device=None):
    """image [H, W, 3(+)] uint8/float -> (degrees uint8 [H, W], variance
    float32 [H, W], filtered float32 [H, W]), computed on ``device`` (CUDA
    by default).  The degrees are filter indices, integer degrees for 180
    filters (the GT loader divides the PNG by 180)."""
    device = resolve_device(device)
    img = np.asarray(image_rgb, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    gray = 0.2989 * img[..., 0] + 0.5870 * img[..., 1] + 0.1140 * img[..., 2]
    filtered = difference_of_gaussians(torch.as_tensor(gray, device=device), dog_low, dog_high)
    bank, thetas = build_gabor_bank(num_filters)
    deg, var = orients_from_filtered(filtered, torch.as_tensor(bank, device=device),
                                     torch.as_tensor(thetas, device=device), num_filters)
    return (deg.to(torch.uint8).cpu().numpy(), var.cpu().numpy(), filtered.cpu().numpy())


def main(argv=None):
    """The calc_orientation_maps CLI: for each mask name, the image's angle
    PNG, variance npy, filtered and visualisation PNGs."""
    import argparse

    from gaussianhaircut_torch.utils.image import read_png, save_image, vis_orient, write_png

    p = argparse.ArgumentParser("calc_orientation_maps")
    p.add_argument("--img_path", required=True)
    p.add_argument("--mask_path", required=True)
    p.add_argument("--orient_dir", required=True)
    p.add_argument("--conf_dir", required=True)
    p.add_argument("--filtered_img_dir", required=True)
    p.add_argument("--vis_img_dir", required=True)
    p.add_argument("--dog_low", default=0.4, type=float)
    p.add_argument("--dog_high", default=10.0, type=float)
    p.add_argument("--num_filters", default=180, type=int)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    for d in (args.orient_dir, args.conf_dir, args.filtered_img_dir, args.vis_img_dir):
        os.makedirs(d, exist_ok=True)
    for name in sorted(os.listdir(args.mask_path)):
        base = name.split(".")[0]
        img = read_png(os.path.join(args.img_path, name))
        deg, var, filtered = calc_orientation_map(
            img, args.dog_low, args.dog_high, args.num_filters, device)
        write_png(f"{args.orient_dir}/{base}.png", deg)
        np.save(f"{args.conf_dir}/{base}.npy", var.astype(np.float16))
        f = (filtered - filtered.min()) / max(filtered.max() - filtered.min(), 1e-9)
        save_image(f, f"{args.filtered_img_dir}/{base}.png")
        mask = read_png(os.path.join(args.mask_path, name)).astype(np.float32) / 255.0
        if mask.ndim == 3:
            mask = mask[..., 0]
        save_image(vis_orient((deg / 180.0)[None], mask[None]),
                   f"{args.vis_img_dir}/{base}.png")


if __name__ == "__main__":
    main()
