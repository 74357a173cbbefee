"""Strand prior networks: latent <-> strand geometry, and the appearance
decoder (port of ``gaussianhaircut_tpu/models/strand_prior.py``).

- ``StrandDecoder`` maps a 64-d geometry latent to L-1 local segment vectors
  from (latent, Fourier features of the arc position): one MLP row per
  segment;
- ``StrandEncoder`` maps local strand points to a latent whose first 64 dims
  are the geometry code;
- ``ColorDecoder`` maps the 64-d appearance latent to SH coefficients and a
  log orientation confidence.

Submodules are registered in the order flax creates them, so
``flax_params`` carries weights between the packages; ``init_weights``
draws flax's initialisers from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gaussianhaircut_torch.models.flax_params import flax_init_

STRAND_LENGTH = 100           # points per strand (export_curves.py:23)
GEOMETRY_DIM = 64             # hair_strands_textured.yaml:13


class MLP(nn.Module):
    """Dense layers of widths ``features`` with ``activation`` between."""

    def __init__(self, in_features: int, features: Sequence[int], activation=F.silu):
        super().__init__()
        widths = [in_features, *features]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.activation = activation

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return x

    def init_weights(self, generator: torch.Generator) -> "MLP":
        return flax_init_(self, generator)


class StrandDecoder(nn.Module):
    """z [.., 64] -> segment vectors [.., L-1, 3] in the canonical local frame."""

    def __init__(self, length: int = STRAND_LENGTH, hidden: int = 256,
                 num_freqs: int = 6, latent_dim: int = GEOMETRY_DIM):
        super().__init__()
        self.length, self.num_freqs = length, num_freqs
        self.latent_in = nn.Linear(latent_dim, hidden)
        self.pos_in = nn.Linear(2 * num_freqs + 1, hidden)
        self.hidden1 = nn.Linear(hidden, hidden)
        self.hidden2 = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, 3)

    def positions(self, device) -> torch.Tensor:
        """[S, 2F+1] Fourier features of the arc position of each segment."""
        t = torch.linspace(0.0, 1.0, self.length - 1, device=device)
        freqs = 2.0 ** torch.arange(self.num_freqs, dtype=torch.float32, device=device)
        ang = t[:, None] * freqs[None, :] * math.pi
        return torch.cat([torch.sin(ang), torch.cos(ang), t[:, None]], -1)

    def forward(self, z):
        h = F.silu(self.latent_in(z))
        h = h[..., None, :] + self.pos_in(self.positions(z.device))
        h = F.silu(self.hidden1(h))
        h = F.silu(self.hidden2(h))
        return self.out(h)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "StrandDecoder":
        flax_init_(self, generator)
        # the last layer starts near zero: normal(1e-2) (strand_prior.py:70)
        self.out.weight.copy_(1e-2 * torch.randn(
            self.out.weight.shape, generator=generator, device=generator.device))
        return self


class StrandEncoder(nn.Module):
    """Local strand points [.., L, 3] -> latent [.., 2 x GEOMETRY_DIM]; the
    first 64 dims are the geometry code."""

    def __init__(self, length: int = STRAND_LENGTH, hidden: int = 256,
                 out_dim: int = 2 * GEOMETRY_DIM):
        super().__init__()
        self.inp = nn.Linear(3 * length, hidden)
        self.hidden = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, out_dim)

    def forward(self, pts):
        x = pts.reshape(pts.shape[:-2] + (-1,))
        x = F.silu(self.inp(x))
        x = F.silu(self.hidden(x))
        return self.out(x)

    def init_weights(self, generator: torch.Generator) -> "StrandEncoder":
        return flax_init_(self, generator)


class ColorDecoder(nn.Module):
    """Appearance latent [.., 64] -> SH coefficients + log orientation
    confidence, 3 (deg + 1)^2 + 1 outputs."""

    def __init__(self, sh_degree: int = 3, hidden: int = 128, in_dim: int = GEOMETRY_DIM):
        super().__init__()
        self.inp = nn.Linear(in_dim, hidden)
        self.hidden = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, 3 * (sh_degree + 1) ** 2 + 1)

    def forward(self, z_app):
        x = F.relu(self.inp(z_app))
        x = F.relu(self.hidden(x))
        return self.out(x)

    def init_weights(self, generator: torch.Generator) -> "ColorDecoder":
        return flax_init_(self, generator)


def points_from_segments(origins: torch.Tensor, segments: torch.Tensor) -> torch.Tensor:
    """origins [N, 1, 3] + cumsum of segment vectors [N, L-1, 3] -> [N, L, 3]
    (gaussian_model_strands.py:436)."""
    return origins + torch.cat([torch.zeros_like(origins),
                                torch.cumsum(segments, dim=1)], dim=1)
