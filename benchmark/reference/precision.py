"""The reference's matrix products and convolutions, in one place so that a
run can compute them at another precision.

``float32`` is the configurations' stated precision (TF32 off).  ``tf32``
is the control of the comparison that decides ``correct``: every operand of
a matrix product or a convolution is rounded to TF32's 10-bit mantissa (round
to nearest even) and the products accumulate in float32, as the tensor
cores compute with TF32 on.  The rounding is done here, not by the backend
flags, so that the CPU computes the control the same way as the card.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_MODE = {"value": "float32"}


@contextlib.contextmanager
def mode(name: str):
    """Run the enclosed reference code at precision ``name``."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    old = _MODE["value"]
    _MODE["value"] = name
    try:
        yield
    finally:
        _MODE["value"] = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to 10 mantissa bits, straight through for the gradient."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def _ops(*xs):
    if _MODE["value"] == "tf32":
        return tuple(round_tf32(x) if x is not None and x.dtype == torch.float32 else x
                     for x in xs)
    return xs


def matmul(a, b):
    a, b = _ops(a, b)
    return a @ b


def einsum(eq, *xs):
    return torch.einsum(eq, *_ops(*xs))


def linear(x, w, b=None):
    x, w = _ops(x, w)
    return F.linear(x, w, b)


def conv2d(x, w, b=None, padding=0, groups=1):
    x, w = _ops(x, w)
    return F.conv2d(x, w, b, padding=padding, groups=groups)
