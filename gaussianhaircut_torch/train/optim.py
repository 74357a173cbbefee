"""Adam with torch.optim.Adam(eps=1e-15) semantics as a functional update on
``TensorRecord`` pytrees, AdamW and the global-norm helpers of the strand
stages, plus the exponential LR schedule (port of
``gaussianhaircut_tpu/train/optim.py``).  The AdamW and norm helpers take
either a ``TensorRecord`` or a dict of tensors keyed by parameter name.

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
    mu: object              # first moments (TensorRecord or dict)
    nu: object              # second moments (TensorRecord or dict)
    count: torch.Tensor     # int32 scalar


def adam_init(params) -> AdamState:
    """Zero moments for a TensorRecord or a dict of tensors."""
    device = next(iter(params.values())).device
    return AdamState(mu=_map(torch.zeros_like, params),
                     nu=_map(torch.zeros_like, params),
                     count=torch.zeros((), dtype=torch.int32, device=device))


def adam_update(grads, state: AdamState, lrs, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15):
    """Returns (updates, new_state).  ``lrs`` is a record (or dict) of
    Python floats matching ``grads``; an lr of 0 freezes that leaf.  Update:
    -lr * m_hat / (sqrt(v_hat) + eps)."""
    count = state.count + 1
    cnt = count.to(torch.float32)
    c1 = 1 - torch.pow(b1, cnt)
    c2 = 1 - torch.pow(b2, cnt)
    mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = _map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    updates = _map(lambda lr, m, v: -lr * (m / c1) / (torch.sqrt(v / c2) + eps),
                   lrs, mu, nu)
    return updates, AdamState(mu, nu, count)


def _map(fn, tree, *others):
    """``jax.tree.map`` over a TensorRecord or a dict of tensors."""
    if isinstance(tree, dict):
        return {k: fn(v, *(o[k] for o in others)) for k, v in tree.items()}
    return tree.map(fn, *others)


def adamw_update(grads, state: AdamState, params, lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01):
    """AdamW as the JAX package writes it (the strand stages' optimizer,
    gaussian_model_latent_strands.py:518): the decoupled decay applies to
    every leaf, scaled by the lr, and the bias corrections use this state's
    own count.  Returns (updates, new_state)."""
    count = state.count + 1
    cnt = count.to(torch.float32)
    c1 = 1 - torch.pow(b1, cnt)
    c2 = 1 - torch.pow(b2, cnt)
    mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = _map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    updates = _map(lambda m, v, p: -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                                          + weight_decay * p), mu, nu, params)
    return updates, AdamState(mu, nu, count)


def where_ok(ok: torch.Tensor, new: AdamState, old: AdamState) -> AdamState:
    """``new`` where the device bool ``ok`` holds, else ``old`` (moments
    and count): the NaN guard keeps a skipped step's optimizer state."""
    keep = lambda a, b: torch.where(ok, a, b)
    return AdamState(_map(keep, new.mu, old.mu), _map(keep, new.nu, old.nu),
                     keep(new.count, old.count))


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))


def clip_by_global_norm(grads, max_norm: float):
    """Scale all gradients by min(1, max_norm / ||grads||) (the strand
    stages' defence against a single bad-view spike, see the JAX package's
    ``optim.clip_by_global_norm``).  Returns (clipped, global norm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return _map(lambda g: g * scale, grads), gnorm


def cap_norm_relative(grads, ref_grads, ratio: float):
    """Scale ``grads`` so its global norm is at most ratio x ||ref_grads||
    (keeps a regularizer from drowning the data terms in per-coordinate
    Adam).  Returns (capped, applied scale)."""
    scale = torch.clamp(ratio * global_norm(ref_grads)
                        / torch.clamp(global_norm(grads), min=1e-12), max=1.0)
    return _map(lambda g: g * scale, grads), scale


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

