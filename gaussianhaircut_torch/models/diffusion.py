"""Latent hair-texture diffusion prior (port of
``gaussianhaircut_tpu/models/diffusion.py``; the k-diffusion ``image_v1``
role, hair_strands_textured.yaml:18-51).

- ``UNetV1``: 64 channels at 32x32 in, channels (128, 256, 512) at depths
  (2, 4, 4), no attention, sigma conditioning through Fourier features ->
  a 256-d mapping MLP -> a per-block scale and shift;
- ``Denoiser``: EDM preconditioning (sigma_data 0.5), lognormal(-1.2, 1.2)
  sigma sampling and the masked denoising loss;
- ``sds_latent_image``: the HAAR-style latent image resampled from guiding
  strands (stage 3's SDS term).

The public functions keep the JAX package's channels-last layout ([N, H, W,
C] latents, a [grid, grid, 64] SDS image); the UNet runs channels-first
inside.  flax's conventions kept: GroupNorm epsilon 1e-6 with 32 groups
where the channels divide by 32 (else 1), 3x3 'SAME' convolutions, 2x2
average pooling, and an exact 2x nearest upsample.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gaussianhaircut_torch.models.flax_params import flax_init_


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """hair_strands_textured.yaml:24-49."""
    input_channels: int = 64
    input_size: int = 32
    mapping_out: int = 256
    depths: Sequence[int] = (2, 4, 4)
    channels: Sequence[int] = (128, 256, 512)
    sigma_data: float = 0.5
    sigma_min: float = 0.02
    sigma_max: float = 40.0
    density_mean: float = -1.2
    density_std: float = 1.2


class FourierFeatures(nn.Module):
    def __init__(self, features: int = 16):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(features // 2))

    def forward(self, x):
        ang = 2 * math.pi * x[..., None] * self.w
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class ResConvBlock(nn.Module):
    """GroupNorm -> SiLU -> conv -> per-channel scale/shift from the
    mapping -> SiLU -> conv, plus a (1x1 conv) skip, over sqrt(2)."""

    def __init__(self, c_in: int, c_out: int, mapping: int):
        super().__init__()
        self.norm = nn.GroupNorm(32 if c_in % 32 == 0 else 1, c_in, eps=1e-6)
        self.cond = nn.Linear(mapping, 2 * c_out)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1)
        self.skip = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x, cond):
        h = F.silu(self.norm(x))
        ss = self.cond(F.silu(cond))
        h = self.conv1(h)
        scale, shift = ss[:, :, None, None].chunk(2, dim=1)
        h = F.silu(h * (1 + scale) + shift)
        h = self.conv2(h)
        skip = x if self.skip is None else self.skip(x)
        return (h + skip) / math.sqrt(2.0)


class UNetV1(nn.Module):
    def __init__(self, cfg: DiffusionConfig):
        super().__init__()
        self.cfg = cfg
        self.fourier = FourierFeatures()
        self.map_in = nn.Linear(16, cfg.mapping_out)
        self.map_out = nn.Linear(cfg.mapping_out, cfg.mapping_out)
        c = cfg.input_channels
        self.down = nn.ModuleList()
        for depth, ch in zip(cfg.depths, cfg.channels):
            for _ in range(depth):
                self.down.append(ResConvBlock(c, ch, cfg.mapping_out))
                c = ch
        self.up = nn.ModuleList()
        for level in reversed(range(len(cfg.depths))):
            ch = cfg.channels[level]
            if level < len(cfg.depths) - 1:
                c += cfg.channels[level]
            for _ in range(cfg.depths[level]):
                self.up.append(ResConvBlock(c, ch, cfg.mapping_out))
                c = ch
        self.out = nn.Conv2d(c, cfg.input_channels, 3, padding=1)

    def forward(self, x, sigma):
        """x [N, H, W, C] channels-last; sigma [N]."""
        mapping = self.map_in(self.fourier(torch.log(sigma) / 4.0))
        mapping = self.map_out(F.silu(mapping))
        # contiguous NCHW: GroupNorm's CPU backward faults on a channels-last input
        h = x.permute(0, 3, 1, 2).contiguous()
        blocks = iter(self.down)
        skips = []
        for level, depth in enumerate(self.cfg.depths):
            if level > 0:
                h = F.avg_pool2d(h, 2)
            for _ in range(depth):
                h = next(blocks)(h, mapping)
            skips.append(h)
        blocks = iter(self.up)
        for level in reversed(range(len(self.cfg.depths))):
            if level < len(self.cfg.depths) - 1:
                h = F.interpolate(h, size=skips[level].shape[-2:], mode="nearest-exact")
                h = torch.cat([h, skips[level]], dim=1)
            for _ in range(self.cfg.depths[level]):
                h = next(blocks)(h, mapping)
        return self.out(h).permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UNetV1":
        flax_init_(self, generator)
        # FourierFeatures' w ~ normal(1.0); the last conv starts at zero
        # (diffusion.py:50, :99)
        self.fourier.w.copy_(torch.randn(self.fourier.w.shape, generator=generator,
                                         device=generator.device))
        self.out.weight.zero_()
        return self


class Denoiser(nn.Module):
    """EDM preconditioning around ``UNetV1``.  Its flax tree is the UNet's:
    ``flax_params`` maps ``Denoiser.net``."""

    def __init__(self, cfg: DiffusionConfig = DiffusionConfig()):
        super().__init__()
        self.cfg = cfg
        self.net = UNetV1(cfg)

    def init_weights(self, generator: torch.Generator) -> "Denoiser":
        self.net.init_weights(generator)
        return self

    def denoise(self, x_noisy, sigma):
        sd2 = self.cfg.sigma_data ** 2
        s = sigma[:, None, None, None]
        c_skip = sd2 / (s ** 2 + sd2)
        c_out = s * self.cfg.sigma_data / torch.sqrt(s ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(s ** 2 + sd2)
        return c_skip * x_noisy + c_out * self.net(c_in * x_noisy, sigma)

    def loss(self, x0, noise, sigma, mask=None):
        """Masked denoising loss with EDM weighting (``loss_wo_logvar``);
        x0, noise [N, H, W, C], sigma [N], mask broadcastable to x0."""
        sd2 = self.cfg.sigma_data ** 2
        weight = ((sigma ** 2 + sd2) / (sigma * self.cfg.sigma_data) ** 2)[:, None, None, None]
        x_noisy = x0 + noise * sigma[:, None, None, None]
        err = (self.denoise(x_noisy, sigma) - x0) ** 2 * weight
        if mask is not None:
            err = err * mask
            return torch.sum(err) / torch.clamp(torch.sum(mask) * x0.shape[-1], min=1.0)
        return torch.mean(err)

    def sample_density(self, shape, generator: torch.Generator) -> torch.Tensor:
        return sample_density(self.cfg, shape, generator)


def sample_density(cfg: DiffusionConfig, shape, generator: torch.Generator) -> torch.Tensor:
    """lognormal(-1.2, 1.2) sigmas clipped to [sigma_min, sigma_max]
    (hair_strands_textured.yaml:45-49), drawn on the generator's device."""
    z = torch.randn(shape, generator=generator, device=generator.device)
    return torch.clamp(torch.exp(cfg.density_mean + cfg.density_std * z),
                       cfg.sigma_min, cfg.sigma_max)


def _k_nearest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of each row, ties to the lower
    index first: ``jax.lax.top_k(-d2, k)``'s order."""
    return torch.sort(d2, dim=-1, stable=True).indices[:, :k]


def sds_latent_image(z_gdn: torch.Tensor, uvs_gdn: torch.Tensor,
                     v_gdn_local: torch.Tensor, grid_size: int,
                     k: int = 4) -> torch.Tensor:
    """HAAR-style latent-texture resampling from guiding strands
    (gaussian_model_strands.py:475-503): k-NN interpolation of the guiding
    strands' latents onto a UV grid, blended between nearest and
    inverse-distance interpolation by the neighbours' direction cosine
    similarity (HAAR eq. 4).

    z_gdn [G, 64]; uvs_gdn [G, 2] in [-1, 1]; v_gdn_local [G, L-1, 3].
    Returns [grid, grid, 64]."""
    g = torch.linspace(-1.0, 1.0, grid_size + 1, device=z_gdn.device)
    g = (g[1:] + g[:-1]) / 2
    uu, vv = torch.meshgrid(g, g, indexing="xy")
    uv_grid = torch.stack([uu, vv], -1).reshape(-1, 2)

    d2 = torch.sum((uv_grid[:, None] - uvs_gdn[None]) ** 2, -1)      # [Q, G]
    idx = _k_nearest(d2, k)
    w = 1.0 / (torch.gather(d2, 1, idx) + 1e-7)
    w = w / torch.sum(w, -1, keepdim=True)
    z_near = z_gdn[idx[:, 0]]
    z_bil = torch.sum(z_gdn[idx] * w[:, :, None], dim=1)

    # each guiding strand's smoothness alpha: the mean pairwise direction
    # cosine similarity among its k nearest guiding strands (diagonal
    # included, as jnp.triu_indices(k) includes it)
    gidx = _k_nearest(torch.sum((uvs_gdn[:, None] - uvs_gdn[None]) ** 2, -1), k)
    vn = v_gdn_local / torch.sqrt(torch.clamp(
        torch.sum(v_gdn_local ** 2, -1, keepdim=True), min=1e-24))
    knn_v = vn[gidx]                                                  # [G, K, S, 3]
    csim = torch.einsum("gksd,glsd->gkls", knn_v, knn_v).mean(-1)     # [G, K, K]
    iu, ju = torch.triu_indices(k, k, device=z_gdn.device)
    csim = csim[:, iu, ju].mean(-1)
    alpha = torch.where(csim <= 0.9, 1 - 1.63 * csim ** 5, 0.4 - 0.4 * csim)

    alpha_q = torch.sum(alpha[idx] * w, dim=1)[:, None]
    z = z_near * alpha_q + z_bil * (1 - alpha_q)
    return z.reshape(grid_size, grid_size, -1)
