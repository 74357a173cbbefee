"""Training losses (port of ``gaussianhaircut_tpu/ops/losses.py``;
reference src/utils/loss_utils.py).  Images are [C, H, W]."""
from __future__ import annotations

import math

import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor, weight=None, mask=None) -> torch.Tensor:
    """Masked/weighted L1: mask multiplies the residual, weight normalizes
    by its own sum."""
    loss = torch.abs(pred - gt)
    if mask is not None:
        loss = loss * mask
    if weight is not None:
        return torch.sum(loss * weight) / torch.sum(weight)
    return torch.mean(loss)


def or_loss(pred: torch.Tensor, gt: torch.Tensor, confs=None, weight=None,
            mask=None) -> torch.Tensor:
    """Wrapped-angle orientation loss (angles in [0, 1] ~ [0, pi)), scaled
    by pi, with the optional aleatoric-confidence term."""
    if weight is None:
        weight = torch.ones_like(gt[:1])
    d = pred - gt
    loss = torch.minimum(torch.abs(d), torch.minimum(torch.abs(d - 1.0),
                                                     torch.abs(d + 1.0)))
    loss = loss * math.pi
    if confs is not None:
        loss = loss * confs - torch.log(confs + 1e-7)
    if mask is not None:
        loss = loss * mask
    return torch.sum(loss * weight) / torch.sum(weight)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    m = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(m))
