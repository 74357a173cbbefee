"""The reference's optimizers: Adam with torch.optim.Adam's eps 1e-15
semantics and per-leaf learning rates (the 3DGS trainer), AdamW with the
decoupled decay scaled by the lr (the strand stages), the global-norm clip,
and the 3DGS exponential lr schedule.  State: dicts of tensors keyed by leaf
name and an integer step count."""
from __future__ import annotations

import math

import torch


def adam(params: dict, grads: dict, mu: dict, nu: dict, count: int, lrs: dict,
         b1=0.9, b2=0.999, eps=1e-15):
    """-> (new params, mu, nu) after one step of count ``count`` (>= 1)."""
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    out_p, out_m, out_v = {}, {}, {}
    for k, g in grads.items():
        out_m[k] = b1 * mu[k] + (1 - b1) * g
        out_v[k] = b2 * nu[k] + (1 - b2) * g * g
        out_p[k] = params[k] - lrs[k] * (out_m[k] / c1) / (torch.sqrt(out_v[k] / c2) + eps)
    return out_p, out_m, out_v


def adamw(params: dict, grads: dict, mu: dict, nu: dict, count: int, lr: float,
          b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01):
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    out_p, out_m, out_v = {}, {}, {}
    for k, g in grads.items():
        out_m[k] = b1 * mu[k] + (1 - b1) * g
        out_v[k] = b2 * nu[k] + (1 - b2) * g * g
        step = (out_m[k] / c1) / (torch.sqrt(out_v[k] / c2) + eps) + weight_decay * params[k]
        out_p[k] = params[k] - lr * step
    return out_p, out_m, out_v


def clip_global_norm(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    """Log-linear decay from lr_init to lr_final over max_steps (the 3DGS
    schedule without a delay: the trainers set no delay steps)."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def finite(grads: dict) -> bool:
    return all(bool(torch.isfinite(g).all()) for g in grads.values())
