"""Cameras: static per-view data + differentiable pose/intrinsics residuals
(port of ``gaussianhaircut_tpu/scene/cameras.py``; reference
src/scene/cameras.py:21-196).

- BARF mode: residual pose = se(3) exp of a 6-vector;
- else: 6D-orthonormalized rotation + translation;
- world_view = (colmap_transform @ residual)^T (row-vector convention);
- intrinsics: FoV + fov residual, projection per graphics_utils.py:51-72;
- camera_center = inv(world_view)[3, :3].
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gaussianhaircut_torch.ops import lie
from gaussianhaircut_torch.ops.projection import CameraGeom
from gaussianhaircut_torch.records import TensorRecord

ZNEAR = 0.01
ZFAR = 100.0


@dataclasses.dataclass
class CameraStatic:
    """Host-side per-view record (constants + ground truth as numpy)."""
    uid: int
    colmap_id: int
    image_name: str
    width: int
    height: int
    colmap_transform: np.ndarray      # [4, 4] column-vector world->cam
    fovx: float
    fovy: float
    image: Optional[np.ndarray] = None          # [3, H, W]
    mask_hair: Optional[np.ndarray] = None      # [1, H, W]
    mask_body: Optional[np.ndarray] = None      # [1, H, W]
    orient_angle: Optional[np.ndarray] = None   # [1, H, W]
    orient_conf: Optional[np.ndarray] = None    # [1, H, W]

    @property
    def mask(self) -> np.ndarray:
        """[2, H, W] = (hair, body)."""
        return np.concatenate([self.mask_hair, self.mask_body], axis=0)


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.zeros(3), scale: float = 1.0) -> np.ndarray:
    """Column-vector w2c from the reference's (R, T) storage, with the
    recenter/rescale hook (graphics_utils.py:38-49).  The reference stores R
    already transposed (camera-to-world rotation)."""
    rt = np.eye(4)
    rt[:3, :3] = R.T
    rt[:3, 3] = t
    c2w = np.linalg.inv(rt)
    c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
    return np.linalg.inv(c2w).astype(np.float32)


@dataclasses.dataclass
class CameraResiduals(TensorRecord):
    """Trainable residuals stacked over N cameras."""
    rotation: torch.Tensor     # [N, 3] (barf) or [N, 6] (ortho6d)
    translation: torch.Tensor  # [N, 3]
    fov: torch.Tensor          # [N, 2]

    @staticmethod
    def create(n: int, use_barf: bool, device) -> "CameraResiduals":
        if use_barf:
            rot = torch.zeros((n, 3), dtype=torch.float32, device=device)
        else:
            rot = torch.tensor([1, 0, 0, 0, 1, 0], dtype=torch.float32,
                               device=device).repeat(n, 1)
        return CameraResiduals(rot, torch.zeros((n, 3), device=device),
                               torch.zeros((n, 2), device=device))


@dataclasses.dataclass
class CameraBatch:
    """Camera constants stacked over N views."""
    colmap_transform: torch.Tensor  # [N, 4, 4]
    fovx: torch.Tensor              # [N]
    fovy: torch.Tensor              # [N]

    @staticmethod
    def from_cameras(cams: list[CameraStatic], device) -> "CameraBatch":
        return CameraBatch(
            torch.as_tensor(np.stack([c.colmap_transform for c in cams]),
                            dtype=torch.float32, device=device),
            torch.as_tensor(np.array([c.fovx for c in cams], np.float32),
                            device=device),
            torch.as_tensor(np.array([c.fovy for c in cams], np.float32),
                            device=device))


def projection_matrix(fovx: torch.Tensor, fovy: torch.Tensor,
                      znear: float = ZNEAR, zfar: float = ZFAR) -> torch.Tensor:
    """Column-vector perspective matrix, z in [0, 1] (graphics_utils.py:51-72)."""
    tx = torch.tan(fovx * 0.5)
    ty = torch.tan(fovy * 0.5)
    z = torch.zeros_like(tx)
    one = torch.ones_like(tx)
    return torch.stack([
        torch.stack([1.0 / tx, z, z, z]),
        torch.stack([z, 1.0 / ty, z, z]),
        torch.stack([z, z, zfar / (zfar - znear) * one,
                     -(zfar * znear) / (zfar - znear) * one]),
        torch.stack([z, z, one, z]),
    ])


def residual_transform(rot_res: torch.Tensor, trans_res: torch.Tensor,
                       use_barf: bool) -> torch.Tensor:
    """[4, 4] residual pose (cameras.py:108-121)."""
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=rot_res.dtype,
                          device=rot_res.device)
    if use_barf:
        rt = lie.se3_to_SE3(torch.cat([rot_res, trans_res]))
    else:
        rt = torch.cat([lie.ortho6d_to_rotation(rot_res), trans_res[:, None]], 1)
    return torch.cat([rt, bottom], 0)


def camera_geom(colmap_transform: torch.Tensor, fovx, fovy, width: int,
                height: int, residuals: CameraResiduals | None = None,
                index=None, use_barf: bool = True,
                trainable_cameras: bool = True,
                trainable_intrinsics: bool = True) -> CameraGeom:
    """Differentiable camera bundle for the renderer; residuals indexed by
    ``index`` (or already per-camera rows if index is None)."""
    if residuals is not None and trainable_intrinsics:
        fr = residuals.fov if index is None else residuals.fov[index]
        fovx = fovx + fr[0]
        fovy = fovy + fr[1]
    if residuals is not None and trainable_cameras:
        rr = residuals.rotation if index is None else residuals.rotation[index]
        tr = residuals.translation if index is None else residuals.translation[index]
        w2c = colmap_transform @ residual_transform(rr, tr, use_barf)
    else:
        w2c = colmap_transform
    viewmatrix = w2c.T
    full_proj = viewmatrix @ projection_matrix(fovx, fovy).T
    campos = torch.linalg.inv(viewmatrix)[3, :3]
    return CameraGeom(viewmatrix=viewmatrix, projmatrix=full_proj,
                      tan_fovx=torch.tan(fovx * 0.5),
                      tan_fovy=torch.tan(fovy * 0.5),
                      width=width, height=height, campos=campos)
