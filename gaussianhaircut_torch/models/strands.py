"""Strand polylines -> segment Gaussians (port of
``gaussianhaircut_tpu/models/strands.py``; gaussian_model_latent_strands.py:
442-504, gaussian_model_strands.py:435-454), shared by stages 2 and 3:

- centres at the segment midpoints;
- rotation: the parallel transport of +x onto the segment (unnormalized
  quaternion [1 + x.d, x cross d]; ``build_rotation`` normalizes it);
- scaling [|segment| / 2, r, r] with r = strand_scale x scene scale.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianhaircut_torch.ops.quaternion import build_rotation, parallel_transport


class StrandGaussians(NamedTuple):
    xyz: torch.Tensor              # [N*(L-1), 3] segment midpoints
    direction: torch.Tensor        # [N*(L-1), 3] segment vectors (unnormalized)
    rotation: torch.Tensor         # [N*(L-1), 4] quaternion (unnormalized)
    rotation_matrix: torch.Tensor  # [N*(L-1), 3, 3]
    scaling: torch.Tensor          # [N*(L-1), 3] activated scales


def strands_to_gaussians(points: torch.Tensor, radius_scale) -> StrandGaussians:
    """points [N, L, 3]; radius_scale: a scalar, strand_scale x scene scale."""
    mid = (0.5 * (points[:, 1:] + points[:, :-1])).reshape(-1, 3)
    seg = (points[:, 1:] - points[:, :-1]).reshape(-1, 3)
    x_axis = torch.zeros_like(seg)
    x_axis[:, 0] = 1.0
    quat = parallel_transport(x_axis, seg)
    # a zero-length segment has a finite gradient through the clamped norm
    half_len = 0.5 * torch.sqrt(torch.clamp(torch.sum(seg * seg, -1, keepdim=True),
                                            min=1e-24))
    r = torch.as_tensor(radius_scale, dtype=seg.dtype, device=seg.device).expand_as(half_len)
    scaling = torch.cat([half_len, r, r], dim=-1)
    return StrandGaussians(mid, seg, quat, build_rotation(quat), scaling)


def per_segment(x: torch.Tensor, segments: int) -> torch.Tensor:
    """Per-strand rows [N, ...] repeated for each of a strand's segments ->
    [N * segments, ...], strand-major as ``strands_to_gaussians`` orders
    its rows."""
    n = x.shape[0]
    return x[:, None].expand(n, segments, *x.shape[1:]).reshape(n * segments, *x.shape[1:])
