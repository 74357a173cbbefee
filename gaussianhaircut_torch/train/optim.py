"""Adam with torch.optim.Adam(eps=1e-15) semantics as a functional update on
``TensorRecord`` pytrees, plus the exponential LR schedule (port of
``gaussianhaircut_tpu/train/optim.py``).

The moments are plain records because densification zeroes moment rows of
cloned/split slots (the optimizer-state surgery of gaussian_model.py:
596-677).  The step count is a device scalar so that the NaN guard can skip
a step (moments and count included) without a host sync.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class AdamState:
    mu: object              # TensorRecord of first moments
    nu: object              # TensorRecord of second moments
    count: torch.Tensor     # int32 scalar


def adam_init(params) -> AdamState:
    device = params.values()[0].device
    return AdamState(mu=params.map(torch.zeros_like),
                     nu=params.map(torch.zeros_like),
                     count=torch.zeros((), dtype=torch.int32, device=device))


def adam_update(grads, state: AdamState, lrs, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15):
    """Returns (updates, new_state).  ``lrs`` is a record of Python floats
    matching ``grads``; an lr of 0 freezes that leaf.  Update:
    -lr * m_hat / (sqrt(v_hat) + eps)."""
    count = state.count + 1
    cnt = count.to(torch.float32)
    c1 = 1 - torch.pow(b1, cnt)
    c2 = 1 - torch.pow(b2, cnt)
    mu = state.mu.map(lambda m, g: b1 * m + (1 - b1) * g, grads)
    nu = state.nu.map(lambda v, g: b2 * v + (1 - b2) * g * g, grads)
    updates = lrs.map(lambda lr, m, v: -lr * (m / c1) / (torch.sqrt(v / c2) + eps),
                      mu, nu)
    return updates, AdamState(mu, nu, count)


def expon_lr(step: int, lr_init: float, lr_final: float,
             lr_delay_steps: float = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1000000) -> float:
    """Log-linear LR decay with optional sine delay ramp
    (general_utils.py:30-63)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if step < 0:
        return 0.0
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def grads_are_finite(grads) -> torch.Tensor:
    """Device bool: every gradient entry is finite (the NaN guard of
    train_gaussians.py:175-178)."""
    return torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
