"""Checkpoint I/O for the strand prior (strand encoder, strand decoder,
latent denoiser), port of ``gaussianhaircut_tpu/models/prior_io.py``.

The file is the JAX package's: one ``.npz`` of float32 arrays under
``encoder/params/...``, ``decoder/params/...`` and ``denoiser/params/...``
(flax key paths, flax layouts), any subset of the three sections.  A prior
written by either package is read by the other; ``models/flax_params.py``
carries the weights.  The widths are read from the arrays, so a prior of
another size loads into modules of its size.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from gaussianhaircut_torch.models.diffusion import Denoiser, DiffusionConfig
from gaussianhaircut_torch.models.flax_params import load_flax_, to_flax
from gaussianhaircut_torch.models.strand_prior import (
    GEOMETRY_DIM, StrandDecoder, StrandEncoder,
)

_SECTIONS = ("encoder", "decoder", "denoiser")


def _flax_module(name: str, module: nn.Module) -> nn.Module:
    return module.net if name == "denoiser" else module


def save_prior(path: str, prior: dict) -> None:
    """prior: any subset of {"encoder", "decoder", "denoiser"} -> module."""
    unknown = set(prior) - set(_SECTIONS)
    if unknown:
        raise ValueError(f"unknown prior sections: {sorted(unknown)}")
    blob = {}
    for name in _SECTIONS:
        if prior.get(name) is not None:
            blob.update(to_flax(_flax_module(name, prior[name]), prefix=f"{name}/params"))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(path, **blob)


def _encoder_for(w: dict) -> StrandEncoder:
    k0, k2 = w["Dense_0/kernel"], w["Dense_2/kernel"]
    return StrandEncoder(length=k0.shape[0] // 3, hidden=k0.shape[1], out_dim=k2.shape[1])


def _decoder_for(w: dict, strand_length: int) -> StrandDecoder:
    k0, k1 = w["Dense_0/kernel"], w["Dense_1/kernel"]
    return StrandDecoder(length=strand_length, hidden=k0.shape[1],
                         num_freqs=(k1.shape[0] - 1) // 2, latent_dim=k0.shape[0])


def _denoiser_for(w: dict, input_size: int) -> Denoiser:
    """The UNet's channels and depths from its blocks' first convolutions:
    the first half of the blocks is the down path."""
    n_blocks = len({k.split("/")[0] for k in w if k.startswith("ResConvBlock_")})
    down = [w[f"ResConvBlock_{i}/Conv_0/kernel"].shape[-1] for i in range(n_blocks // 2)]
    channels, depths = [], []
    for c in down:
        if channels and channels[-1] == c:
            depths[-1] += 1
        else:
            channels.append(c)
            depths.append(1)
    return Denoiser(DiffusionConfig(
        input_channels=w["Conv_0/kernel"].shape[-1], input_size=input_size,
        mapping_out=w["Dense_0/kernel"].shape[1], depths=tuple(depths),
        channels=tuple(channels)))


def load_prior(path: str, strand_length: int = 100, diffusion_input: int = 32,
               device=None) -> dict:
    """{"encoder": StrandEncoder, "decoder": StrandDecoder, "denoiser":
    Denoiser} for the sections present in an npz written by ``save_prior``
    of either package, on ``device`` (default: the CPU)."""
    with np.load(path) as z:
        d = dict(z)
    out = {}
    for name in _SECTIONS:
        pre = f"{name}/params/"
        w = {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}
        if not w:
            continue
        module = {"encoder": lambda: _encoder_for(w),
                  "decoder": lambda: _decoder_for(w, strand_length),
                  "denoiser": lambda: _denoiser_for(w, diffusion_input)}[name]()
        load_flax_(_flax_module(name, module), d, prefix=f"{name}/params")
        out[name] = module.to(device or "cpu")
    if not out:
        raise ValueError(f"{path} holds no encoder/decoder/denoiser sections "
                         f"(keys: {sorted(d)[:5]}...)")
    return out


def load_strand_prior(path: str, strand_length: int = 100, diffusion_input: int = 32,
                      device=None) -> dict:
    """The stage-3 SDS prior: at least the encoder section."""
    prior = load_prior(path, strand_length, diffusion_input, device)
    if "encoder" not in prior:
        raise ValueError(f"{path} has no 'encoder/...' keys; stage-3 SDS "
                         "needs the strand encoder")
    return prior


def init_prior(scfg, generator: torch.Generator, device=None) -> dict:
    """A fresh (untrained) prior of the configured widths, drawn from
    ``generator`` with flax's initialisers (encoder, decoder, denoiser in
    that order): the from-scratch fallback when no converted upstream
    checkpoint is available."""
    enc = StrandEncoder(length=scfg.strand_length).init_weights(generator)
    dec = StrandDecoder(length=scfg.strand_length).init_weights(generator)
    den = Denoiser(DiffusionConfig(input_channels=GEOMETRY_DIM,
                                   input_size=scfg.diffusion_input)).init_weights(generator)
    return {k: m.to(device or "cpu") for k, m in
            (("encoder", enc), ("decoder", dec), ("denoiser", den))}
