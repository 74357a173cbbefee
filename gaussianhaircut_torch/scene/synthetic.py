"""The bench scene: a seeded Gaussian point blob seen by cameras on a ring,
with random ground truth (the scene ``bench.py:36-99`` builds for the JAX
package, rebuilt here so the port needs nothing of it), and a writer that
puts such a scene on disk in the COLMAP layout ``scene.dataset.load_scene``
reads."""
from __future__ import annotations

import math
import os
import types

import numpy as np

from gaussianhaircut_torch.scene import colmap, ply
from gaussianhaircut_torch.scene.cameras import CameraStatic
from gaussianhaircut_torch.utils.image import save_image


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


def write_colmap_scene(scene, root: str, images: str = "images_2") -> None:
    """Write ``scene`` (``train_cameras`` with ground truth, ``points``,
    ``colors`` in [0, 1]) under ``root``: ``sparse/0/{cameras,images}.txt``
    (PINHOLE, principal point at the centre) and ``sparse/0/points3D.ply``,
    ``<images>/<name>.png``, ``masks_2/{hair,body}/<name>.png``,
    ``orientations_2/angles/<name>.png`` (degrees) and
    ``orientations_2/vars/<name>.npy`` (the variance whose confidence
    ``load_view_gt`` computes is the camera's ``orient_conf``).  Images are
    stored as 8-bit PNGs, so the loaded ground truth is the scene's
    quantized to 1/255 (angles to 1/180)."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    cams, imgs = {}, {}
    for i, c in enumerate(scene.train_cameras):
        fx = c.width / (2 * math.tan(c.fovx / 2))
        fy = c.height / (2 * math.tan(c.fovy / 2))
        cams[i + 1] = colmap.ColmapCamera(i + 1, "PINHOLE", c.width, c.height,
                                          np.array([fx, fy, c.width / 2, c.height / 2]))
        w2c = np.asarray(c.colmap_transform, np.float64)
        imgs[i + 1] = colmap.ColmapImage(i + 1, colmap.rotmat_to_qvec(w2c[:3, :3]),
                                         w2c[:3, 3], i + 1, f"{c.image_name}.png")
        name = f"{c.image_name}.png"
        save_image(c.image, os.path.join(root, images, name))
        save_image(c.mask_hair, os.path.join(root, "masks_2", "hair", name))
        save_image(c.mask_body, os.path.join(root, "masks_2", "body", name))
        save_image(c.orient_angle * (180.0 / 255.0),
                   os.path.join(root, "orientations_2", "angles", name))
        var = math.pi ** 2 * np.sqrt(np.maximum(1.0 / c.orient_conf[0] - 1e-7, 0.0))
        os.makedirs(os.path.join(root, "orientations_2", "vars"), exist_ok=True)
        np.save(os.path.join(root, "orientations_2", "vars", f"{c.image_name}.npy"),
                var.astype(np.float32))
    colmap.write_cameras_text(os.path.join(sparse, "cameras.txt"), cams)
    colmap.write_images_text(os.path.join(sparse, "images.txt"), imgs)
    ply.store_point_cloud(os.path.join(sparse, "points3D.ply"),
                          np.asarray(scene.points, np.float64),
                          np.asarray(scene.colors, np.float64) * 255.0)
