"""Per-Gaussian camera geometry: EWA covariance projection, conics, NDC
means, depths and 2D strand directions (port of
``gaussianhaircut_tpu/ops/projection.py``; reference
src/scene/gaussian_model.py:143-393).

The load-bearing constants are the reference's: 0.3 cov dilation, 1.3*tanfov
clamp, 1e-12 det eps, 1e-7 w eps.  ``viewmatrix``/``projmatrix`` are
ROW-VECTOR 4x4 transforms: x_view = x @ M[:3, :3] + M[3, :3].
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class CameraGeom:
    """Camera bundle used by the ops layer."""
    viewmatrix: torch.Tensor      # [4, 4] row-vector world->view
    projmatrix: torch.Tensor      # [4, 4] row-vector world->NDC
    tan_fovx: torch.Tensor        # scalar
    tan_fovy: torch.Tensor        # scalar
    width: int
    height: int
    campos: torch.Tensor          # [3]


def to_view(xyz: torch.Tensor, viewmatrix: torch.Tensor) -> torch.Tensor:
    """[P, 3] world -> view (row-vector convention)."""
    return xyz @ viewmatrix[:3, :3] + viewmatrix[3, :3]


def project_ndc(xyz: torch.Tensor, projmatrix: torch.Tensor) -> torch.Tensor:
    """[P, 3] world -> NDC [P, 3] with the reference's 1e-7 w-eps."""
    p_hom = xyz @ projmatrix[:3, :] + projmatrix[3, :]
    p_w = 1.0 / (p_hom[:, 3:4] + 1e-7)
    return p_hom[:, :3] * p_w


def focals(cam: CameraGeom):
    return cam.width / (2.0 * cam.tan_fovx), cam.height / (2.0 * cam.tan_fovy)


def _ewa_jacobian_T(xyz: torch.Tensor, cam: CameraGeom) -> torch.Tensor:
    """T = W @ J [P, 3, 3] (gaussian_model.py:252-301): rows index world
    axes, columns (x_img, y_img, unused)."""
    focal_x, focal_y = focals(cam)
    t = to_view(xyz, cam.viewmatrix)
    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    limx = 1.3 * cam.tan_fovx
    limy = 1.3 * cam.tan_fovy
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz
    zeros = torch.zeros_like(tz)
    j_col0 = torch.stack([focal_x / tz, zeros, -(focal_x * tx) / (tz * tz)], dim=-1)
    j_col1 = torch.stack([zeros, focal_y / tz, -(focal_y * ty) / (tz * tz)], dim=-1)
    j_col2 = torch.stack([zeros, zeros, zeros], dim=-1)
    jac = torch.stack([j_col0, j_col1, j_col2], dim=-1)
    return cam.viewmatrix[None, :3, :3] @ jac


def covariance_3d(scaling: torch.Tensor, rotation_matrix: torch.Tensor) -> torch.Tensor:
    """[P, 3, 3] = (S R)^T (S R), S = diag(scaling)."""
    m = scaling[:, :, None] * rotation_matrix
    return m.transpose(1, 2) @ m


def covariance_2d(xyz: torch.Tensor, cov3d_full: torch.Tensor,
                  cam: CameraGeom) -> torch.Tensor:
    """EWA-projected 2D covariance, packed [P, 3] = (c00, c01, c11), +0.3."""
    t = _ewa_jacobian_T(xyz, cam)
    cov2d = t.transpose(1, 2) @ cov3d_full @ t
    return torch.stack([cov2d[:, 0, 0] + 0.3, cov2d[:, 0, 1],
                        cov2d[:, 1, 1] + 0.3], dim=-1)


def conic_from_cov2d(cov2d: torch.Tensor) -> torch.Tensor:
    """Packed 2x2 covariance -> conic (a, b, c) with the 1e-12 det eps."""
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    det_inv = 1.0 / (det + 1e-12)
    return torch.stack([cov2d[:, 2], -cov2d[:, 1], cov2d[:, 0]], dim=-1) * det_inv[:, None]


def depths(xyz: torch.Tensor, cam: CameraGeom) -> torch.Tensor:
    """View-space z [P, 1]."""
    return to_view(xyz, cam.viewmatrix)[:, 2:3]


def principal_axis(scaling: torch.Tensor, rotation_matrix: torch.Tensor) -> torch.Tensor:
    """Row of R for the largest scale, times that scale [P, 3] (first max
    wins ties, like argmax)."""
    j = torch.argmax(scaling, dim=-1)
    onehot = torch.nn.functional.one_hot(j, scaling.shape[-1]).to(scaling.dtype)
    rows = torch.einsum("pk,pkj->pj", onehot, rotation_matrix)
    s = torch.sum(scaling * onehot, dim=-1, keepdim=True)
    return rows * s


def direction_2d(xyz: torch.Tensor, scaling: torch.Tensor,
                 rotation_matrix: torch.Tensor, cam: CameraGeom) -> torch.Tensor:
    """Screen-space strand direction [P, 3] (3rd component 0): the longest
    axis projected through T = W @ J (gaussian_model.py:344-393)."""
    t = _ewa_jacobian_T(xyz, cam)
    d = principal_axis(scaling, rotation_matrix)
    return torch.einsum("pi,pij->pj", d, t)
