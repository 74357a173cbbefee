"""Carry network parameters between the JAX package's flax trees and the
port's ``nn.Module``s.

A flax tree arrives flattened, as numpy arrays under "/"-joined key paths
(``params/Dense_0/kernel``, ``params/ResConvBlock_3/Conv_1/bias``,
``params/ResConvBlock_0/GroupNorm_0/scale``,
``params/FourierFeatures_0/w``): the layout of the JAX package's prior npz
files and stage-2 checkpoints.  Flax names a module's submodules by type and
creation order (``Dense_0``, ``Dense_1``, ...); the port's modules register
their submodules in the same order, so the names follow from a walk over
the module tree, where ``ModuleList``s are transparent.  The layouts differ:

- a Dense kernel ``[in, out]`` is a ``Linear`` weight ``[out, in]``;
- a Conv kernel HWIO is a ``Conv2d`` weight OIHW;
- a GroupNorm's ``scale`` / ``bias`` are its ``weight`` / ``bias``.

Besides parameters, the same mapping carries anything of a parameter's
shape keyed by parameter name: Adam moments, an EMA copy.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

_FLAX_TYPE = {nn.Linear: "Dense", nn.Conv2d: "Conv", nn.GroupNorm: "GroupNorm"}
_LEAF_NAMES = {"Dense": {"weight": "kernel", "bias": "bias"},
               "Conv": {"weight": "kernel", "bias": "bias"},
               "GroupNorm": {"weight": "scale", "bias": "bias"}}


def _children(module: nn.Module, prefix: str):
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            yield from _children(child, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", child


def flax_names(module: nn.Module) -> dict[str, tuple[str, str]]:
    """Parameter name -> (flax path below ``params/``, layout), the layout
    being ``dense``, ``conv`` or ``same``."""
    out: dict[str, tuple[str, str]] = {}

    def walk(mod: nn.Module, tprefix: str, fprefix: str) -> None:
        for name, _ in mod.named_parameters(recurse=False):
            out[tprefix + name] = (fprefix + name, "same")
        counts: dict[str, int] = {}
        for tname, child in _children(mod, ""):
            ftype = _FLAX_TYPE.get(type(child), type(child).__name__)
            fname = f"{fprefix}{ftype}_{counts.get(ftype, 0)}"
            counts[ftype] = counts.get(ftype, 0) + 1
            if ftype in _LEAF_NAMES:
                layout = {"Dense": "dense", "Conv": "conv"}.get(ftype, "same")
                for pname, _ in child.named_parameters(recurse=False):
                    out[f"{tprefix}{tname}.{pname}"] = (
                        f"{fname}/{_LEAF_NAMES[ftype][pname]}",
                        layout if pname == "weight" else "same")
            else:
                walk(child, f"{tprefix}{tname}.", fname + "/")

    walk(module, "", "")
    return out


def to_flax_layout(t: torch.Tensor, layout: str) -> np.ndarray:
    """A tensor in the port's layout -> a numpy array in flax's."""
    a = t.detach().cpu().numpy()
    if layout == "dense":
        return np.ascontiguousarray(a.T)
    if layout == "conv":
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    return a


def from_flax_layout(a: np.ndarray, layout: str) -> np.ndarray:
    """A numpy array in flax's layout -> the port's layout."""
    if layout == "dense":
        return np.ascontiguousarray(a.T)
    if layout == "conv":
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    return a


def to_flax(module: nn.Module, tensors: dict | None = None,
            prefix: str = "params") -> dict[str, np.ndarray]:
    """The flat flax tree of ``module``'s parameters (or of ``tensors``, a
    dict keyed by its parameter names), under ``prefix/``."""
    if tensors is None:
        tensors = dict(module.named_parameters())
    return {f"{prefix}/{path}": to_flax_layout(tensors[name], layout)
            for name, (path, layout) in flax_names(module).items()}


def from_flax(module: nn.Module, flat: dict, prefix: str = "params") -> dict[str, torch.Tensor]:
    """Parameter name -> float32 tensor in the module's layout (on its
    device), read from a flat flax tree under ``prefix/``.  Raises on a
    missing or unknown key and on a shape that does not fit the module."""
    names = flax_names(module)
    params = dict(module.named_parameters())
    wanted = {f"{prefix}/{path}" for path, _ in names.values()}
    have = {k for k in flat if k.startswith(prefix + "/")}
    if wanted != have:
        raise ValueError(
            f"flax tree under {prefix!r} does not match {type(module).__name__}: "
            f"missing {sorted(wanted - have)[:4]}, unknown {sorted(have - wanted)[:4]}")
    out = {}
    for name, (path, layout) in names.items():
        a = from_flax_layout(np.array(flat[f"{prefix}/{path}"], np.float32), layout)
        if tuple(a.shape) != tuple(params[name].shape):
            raise ValueError(f"{prefix}/{path}: shape {a.shape} does not fit "
                             f"{name} {tuple(params[name].shape)}")
        out[name] = torch.as_tensor(a, device=params[name].device)
    return out


@torch.no_grad()
def load_flax_(module: nn.Module, flat: dict, prefix: str = "params") -> nn.Module:
    """Copy a flat flax tree into ``module``'s parameters in place."""
    params = dict(module.named_parameters())
    for name, t in from_flax(module, flat, prefix).items():
        params[name].copy_(t)
    return module


# ----------------------------------------------------- flax initialisers --

@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init, ``lecun_normal``: a normal truncated at
    two standard deviations, scaled to variance 1 / fan_in (fan_in from the
    torch layout: in_features, or in_channels x kh x kw)."""
    fan_in = weight.shape[1] * int(np.prod(weight.shape[2:], dtype=np.int64))
    # the standard deviation of a unit normal truncated to [-2, 2]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    lo, hi = (1 + math.erf(-2.0 / 2 ** 0.5)) / 2, (1 + math.erf(2.0 / 2 ** 0.5)) / 2
    u = torch.rand(weight.shape, generator=generator, dtype=torch.float64,
                   device=generator.device)
    x = torch.erfinv(2 * (lo + (hi - lo) * u) - 1) * 2 ** 0.5
    weight.copy_(torch.clamp(x, -2.0, 2.0) * std)
    return weight


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's defaults for every Dense and Conv (lecun-normal kernel, zero
    bias) and GroupNorm (unit scale, zero bias) in the module, in parameter
    order; modules with their own init apply it afterwards."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return module
