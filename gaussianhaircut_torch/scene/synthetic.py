"""The bench scene: a seeded Gaussian point blob seen by cameras on a ring,
with random ground truth (the scene ``bench.py:36-99`` builds for the JAX
package, rebuilt here so the port needs nothing of it)."""
from __future__ import annotations

import math
import types

import numpy as np

from gaussianhaircut_torch.scene.cameras import CameraStatic


def bench_scene(num_points: int = 100_000, width: int = 960, height: int = 544,
                n_views: int = 4, seed: int = 0):
    """-> object with ``train_cameras``, ``points``, ``colors`` and
    ``cameras_extent``, the input ``train.stage1.train`` takes."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=0.3, size=(num_points, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, size=(num_points, 3)).astype(np.float32)
    cams = []
    fov = math.radians(50)
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        center = np.array([2.5 * math.sin(a), 0.3, 2.5 * math.cos(a)])
        fwd = -center / np.linalg.norm(center)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=0)
        w2c[:3, 3] = -w2c[:3, :3] @ center
        c = CameraStatic(uid=i, colmap_id=i, image_name=f"{i:04d}", width=width,
                         height=height, colmap_transform=w2c, fovx=fov, fovy=fov)
        c.image = rng.uniform(size=(3, height, width)).astype(np.float32)
        c.mask_hair = np.full((1, height, width), 0.5, np.float32)
        c.mask_body = np.ones((1, height, width), np.float32)
        c.orient_angle = rng.uniform(size=(1, height, width)).astype(np.float32)
        c.orient_conf = np.ones((1, height, width), np.float32)
        cams.append(c)
    return types.SimpleNamespace(train_cameras=cams, points=pts, colors=cols,
                                 cameras_extent=1.0)
