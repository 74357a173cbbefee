"""Mean squared distance to the k nearest neighbours (port of
``gaussianhaircut_tpu/ops/knn.py``, the simple-knn ``distCUDA2``
equivalent used once to initialize Gaussian scales,
gaussian_model.py:409-410).  Blocked squared distances by one matmul per
block (the JAX package's |a|^2 + |b|^2 - 2 a.b expansion, which is also
``torch.cdist``'s matmul path) + ``topk`` with a running top-(k+1) merge, so
the peak distance matrix is [block, chunk]."""
from __future__ import annotations

import torch


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3, block_size: int = 1024,
                     chunk_size: int = 65536) -> torch.Tensor:
    """points [P, 3] -> [P]: mean squared distance to the k nearest other
    points (the self-distance, the smallest, is dropped)."""
    p = points.shape[0]
    out = torch.empty(p, dtype=points.dtype, device=points.device)
    kk = min(k + 1, p)
    for q0 in range(0, p, block_size):
        qry = points[q0:q0 + block_size]
        best = None
        for r0 in range(0, p, chunk_size):
            ref = points[r0:r0 + chunk_size]
            d2 = (torch.sum(qry * qry, -1)[:, None] + torch.sum(ref * ref, -1)[None, :]
                  - 2.0 * qry @ ref.T).clamp_min(0.0)
            top = torch.topk(d2, min(kk, d2.shape[1]), dim=1, largest=False).values
            best = top if best is None else torch.topk(
                torch.cat([best, top], 1), kk, dim=1, largest=False).values
        out[q0:q0 + block_size] = best[:, 1:].mean(dim=-1)
    return out
