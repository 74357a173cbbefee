"""SO(3)/SE(3) exponential maps for BARF camera residuals and the 6D rotation
parameterization (port of ``gaussianhaircut_tpu/ops/lie.py``; reference
camera_opt_utils.py:62-141 and cameras.py:170-196).  Taylor-series
coefficients keep the maps smooth at theta = 0, where the residuals start."""
from __future__ import annotations

import torch

from gaussianhaircut_torch.ops.quaternion import normalize

_NTH = 10


def _taylor(x2: torch.Tensor, kind: str) -> torch.Tensor:
    """sin(x)/x (A), (1-cos x)/x^2 (B), (x-sin x)/x^3 (C) as series in x^2."""
    ans = torch.zeros_like(x2)
    denom = 1.0
    pow_ = torch.ones_like(x2)
    for i in range(_NTH + 1):
        if kind == "A":
            if i > 0:
                denom *= (2 * i) * (2 * i + 1)
        elif kind == "B":
            denom *= (2 * i + 1) * (2 * i + 2)
        else:
            denom *= (2 * i + 2) * (2 * i + 3)
        ans = ans + ((-1) ** i) * pow_ / denom
        pow_ = pow_ * x2
    return ans


def skew(w: torch.Tensor) -> torch.Tensor:
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([o, -w2, w1], dim=-1),
        torch.stack([w2, o, -w0], dim=-1),
        torch.stack([-w1, w0, o], dim=-1),
    ], dim=-2)


def so3_to_SO3(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] rotation (Rodrigues, Taylor-safe at 0)."""
    wx = skew(w)
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    a = _taylor(th2, "A")
    b = _taylor(th2, "B")
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * wx + b * (wx @ wx)


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    """[..., 6] (w | u) -> [..., 3, 4] pose [R | V u]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    a = _taylor(th2, "A")
    b = _taylor(th2, "B")
    c = _taylor(th2, "C")
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    rot = eye + a * wx + b * (wx @ wx)
    v = eye + b * wx + c * (wx @ wx)
    t = torch.einsum("...ij,...j->...i", v, u)
    return torch.cat([rot, t[..., None]], dim=-1)


def ortho6d_to_rotation(poses: torch.Tensor) -> torch.Tensor:
    """6D rotation parameterization -> [..., 3, 3] with columns (x, y, z),
    with cameras.py:170-196's eps placement."""
    x_raw = poses[..., 0:3]
    y_raw = poses[..., 3:6]
    x = normalize(x_raw)
    inner = torch.sum(x * y_raw, dim=-1, keepdim=True)
    norm2 = torch.clamp(torch.sum(x * x, dim=-1, keepdim=True), min=1e-8)
    y = normalize(y_raw - inner / (norm2 + 1e-10) * x)
    z = torch.cross(x, y, dim=-1)
    return torch.stack([x, y, z], dim=-1)
