"""Quaternion utilities (port of ``gaussianhaircut_tpu/ops/quaternion.py``).

``build_rotation`` keeps the reference's column-major construction
(general_utils.py:79-120): R is the transpose of the textbook
quaternion-to-matrix, so the Gaussian's principal axes are the ROWS of R.
"""
from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """v / sqrt(max(||v||^2, eps^2)): finite gradient at v = 0."""
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return v / torch.sqrt(torch.clamp(n2, min=eps * eps))


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) [..., 4] (w, x, y, z), not necessarily unit -> [..., 3, 3].
    A zero quaternion maps to the identity (clamped norm)."""
    q = normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + r * z), 2 * (x * z - r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y - r * z), 1 - 2 * (x * x + z * z), 2 * (y * z + r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z + r * y), 2 * (y * z - r * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def parallel_transport(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unnormalized quaternion [1 + a.b, a x b] rotating direction a onto b,
    with a and b normalized first (general_utils.py:150-160).  It stays
    unnormalized: ``build_rotation`` normalizes it."""
    a = normalize(a)
    b = normalize(b)
    s = 1.0 + torch.sum(a * b, dim=-1, keepdim=True)
    return torch.cat([s, torch.linalg.cross(a, b, dim=-1)], dim=-1)
