"""Chamfer and sided point-cloud distances (port of
``gaussianhaircut_tpu/ops/chamfer.py``): exact blocked brute-force nearest
neighbours, one matrix product per block of 2048 source points, and
differentiable.

The JAX package's arithmetic is kept: each block's squared distances are
(|a|^2 + |b|^2) - 2 a.b, the product in full float32 (never TF32, whose
rounding would move the argmin at near-ties), the nearest point is the
lowest index among equal distances (``jnp.argmin``'s rule), and the result
is clamped at 0.  No kernel: a [block, M] product and a row minimum are
what the card's libraries already do well.
"""
from __future__ import annotations

import contextlib

import torch

BLOCK = 2048


@contextlib.contextmanager
def _full_fp32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _nearest(src: torch.Tensor, dst: torch.Tensor, block: int):
    """(d2 [N], idx [N]) without autograd: each block's distance matrix is
    formed in place and its row minima taken."""
    dst_sq = torch.sum(dst * dst, dim=-1)
    d2_out, idx_out = [], []
    with torch.no_grad(), _full_fp32():
        for chunk in torch.split(src, block):
            d2 = torch.sum(chunk * chunk, dim=-1)[:, None] + dst_sq[None]
            d2.sub_(chunk @ dst.T, alpha=2.0)            # a - 2 b: 2 b is exact
            # torch.min's index is the first of equal minima on every backend
            best, idx = torch.min(d2, dim=-1)
            d2_out.append(best)
            idx_out.append(idx)
            del d2
    return torch.cat(d2_out), torch.cat(idx_out)


def sided_distance(src: torch.Tensor, dst: torch.Tensor, block: int = BLOCK):
    """For each src point, the squared distance to its nearest dst point.
    src [N, 3], dst [M, 3] -> (dist2 [N], idx [N] int64).  The distance
    carries the gradient of the selected entries of the JAX package's
    distance matrix, to src and to dst."""
    d2, idx = _nearest(src.detach(), dst.detach(), block)
    if src.requires_grad or dst.requires_grad:
        near = dst[idx]
        sel = (torch.sum(src * src, -1) + torch.sum(near * near, -1)
               - 2.0 * torch.sum(src * near, -1))
        d2 = d2 + (sel - sel.detach())
    return torch.clamp(d2, min=0.0), idx


def chamfer_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer distance between point clouds [N, 3] and [M, 3]:
    the mean of both sided means (the 'mean' reduction of the reference's
    loss_chamfer_utils.py)."""
    dx, _ = sided_distance(x, y)
    dy, _ = sided_distance(y, x)
    return torch.mean(dx) + torch.mean(dy)
