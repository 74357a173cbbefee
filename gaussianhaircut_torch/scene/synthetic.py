"""The bench scene: a seeded Gaussian point blob seen by cameras on a ring,
with random ground truth (the scene ``bench.py:36-99`` builds for the JAX
package, rebuilt here so the port needs nothing of it), a writer that
puts such a scene on disk in the COLMAP layout ``scene.dataset.load_scene``
reads, and the pipeline's input scene: images, masks, COLMAP text and a
closed head mesh of about FLAME's size with its scalp cap."""
from __future__ import annotations

import math
import os
import types

import numpy as np

from gaussianhaircut_torch.scene import colmap, ply
from gaussianhaircut_torch.scene.cameras import CameraStatic
from gaussianhaircut_torch.utils import mesh as mesh_util
from gaussianhaircut_torch.utils.image import save_image, write_png


def ring_cameras(n_views: int = 4, width: int = 960, height: int = 544) -> list:
    """``n_views`` cameras evenly on a horizontal ring around the origin,
    looking at it, without ground truth."""
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
        cams.append(CameraStatic(uid=i, colmap_id=i, image_name=f"{i:04d}", width=width,
                                 height=height, colmap_transform=w2c, fovx=fov, fovy=fov))
    return cams


def bench_scene(num_points: int = 100_000, width: int = 960, height: int = 544,
                n_views: int = 4, seed: int = 0):
    """-> object with ``train_cameras``, ``points``, ``colors`` and
    ``cameras_extent``, the input ``train.stage1.train`` takes."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=0.3, size=(num_points, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, size=(num_points, 3)).astype(np.float32)
    cams = ring_cameras(n_views, width, height)
    for c in cams:
        c.image = rng.uniform(size=(3, height, width)).astype(np.float32)
        c.mask_hair = np.full((1, height, width), 0.5, np.float32)
        c.mask_body = np.ones((1, height, width), np.float32)
        c.orient_angle = rng.uniform(size=(1, height, width)).astype(np.float32)
        c.orient_conf = np.ones((1, height, width), np.float32)
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


def sphere_mesh(center=(0.0, 0.05, 0.0), radius: float = 0.1, n_lat: int = 70,
                n_lon: int = 72) -> mesh_util.Mesh:
    """A closed latitude-longitude sphere with outward-facing triangles:
    2 + (n_lat - 1) n_lon vertices, 2 n_lon (n_lat - 1) faces (9,936 at the
    defaults, about a FLAME head's 9,976).  The defaults put it under the
    synthetic scalp cap (``models.textured_strands.synthetic_scalp_pool``)."""
    theta = np.pi * np.arange(1, n_lat) / n_lat
    phi = 2 * np.pi * np.arange(n_lon) / n_lon
    ring = np.stack([np.sin(theta)[:, None] * np.cos(phi)[None],
                     np.repeat(np.cos(theta)[:, None], n_lon, 1),
                     np.sin(theta)[:, None] * np.sin(phi)[None]], -1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]]) * radius
    verts = verts + np.asarray(center, np.float64)
    top, bottom = 0, len(verts) - 1
    at = lambda i, j: 1 + i * n_lon + j % n_lon
    faces = []
    for j in range(n_lon):
        faces.append([top, at(0, j + 1), at(0, j)])
        faces.append([bottom, at(n_lat - 2, j), at(n_lat - 2, j + 1)])
        for i in range(n_lat - 2):
            faces.append([at(i, j), at(i, j + 1), at(i + 1, j)])
            faces.append([at(i, j + 1), at(i + 1, j + 1), at(i + 1, j)])
    faces = np.asarray(faces, np.int64)
    tri = verts[faces] - np.asarray(center)
    if np.einsum("fi,fi->f", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() < 0:
        faces = faces[:, ::-1].copy()            # outward, so inside has winding 1
    return mesh_util.Mesh(verts, faces, None, None)


def cap_mesh(mesh: mesh_util.Mesh, center) -> mesh_util.Mesh:
    """The faces of ``mesh`` whose centroid direction from ``center`` is
    within 60 degrees of +y (the scalp of ``sphere_mesh``), with the
    vertices they use."""
    c = mesh.verts[mesh.faces].mean(axis=1) - np.asarray(center)
    sel = mesh.faces[c[:, 1] / np.linalg.norm(c, axis=1) >= 0.5]
    used, inv = np.unique(sel, return_inverse=True)
    return mesh_util.Mesh(mesh.verts[used], inv.reshape(sel.shape), None, None)


def write_pipeline_scene(root: str, cameras, images: np.ndarray, hair: np.ndarray,
                         body: np.ndarray, points: np.ndarray, colors: np.ndarray,
                         head: mesh_util.Mesh | None = None) -> None:
    """A scene directory as the pipeline starts from it (run.sh's layout
    after COLMAP and the mask networks): ``images/<i:06d>.png`` (uint8
    [V, H, W, 3]), ``masks/{hair,face,body}/`` (uint8 [V, H, W]; face = body
    - hair), ``sparse/0/`` and ``sparse_txt/`` as COLMAP text (one PINHOLE
    camera per view, principal point at the centre; the points with colours
    in [0, 1]) and, with a ``head`` mesh, the FLAME fit's files for the
    default experiment, ``flame_fitting/stage1/stage_3/mesh_final.obj`` and
    ``.../scalp_data/scalp.obj`` (its cap)."""
    names = [f"{i:06d}.png" for i in range(len(cameras))]
    for sub in ("images", "masks/hair", "masks/face", "masks/body"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    cams, imgs = {}, {}
    for i, (c, name) in enumerate(zip(cameras, names)):
        fx = c.width / (2 * math.tan(c.fovx / 2))
        fy = c.height / (2 * math.tan(c.fovy / 2))
        cams[i + 1] = colmap.ColmapCamera(i + 1, "PINHOLE", c.width, c.height,
                                          np.array([fx, fy, c.width / 2, c.height / 2]))
        w2c = np.asarray(c.colmap_transform, np.float64)
        imgs[i + 1] = colmap.ColmapImage(i + 1, colmap.rotmat_to_qvec(w2c[:3, :3]),
                                         w2c[:3, 3], i + 1, name)
        face = np.clip(body[i].astype(np.int32) - hair[i].astype(np.int32), 0, 255)
        write_png(os.path.join(root, "images", name), images[i])
        write_png(os.path.join(root, "masks", "hair", name), hair[i])
        write_png(os.path.join(root, "masks", "body", name), body[i])
        write_png(os.path.join(root, "masks", "face", name), face.astype(np.uint8))
    rgb = np.clip(np.round(np.asarray(colors) * 255), 0, 255).astype(np.uint8)
    for sub in ("sparse/0", "sparse_txt"):
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        colmap.write_cameras_text(os.path.join(d, "cameras.txt"), cams)
        colmap.write_images_text(os.path.join(d, "images.txt"), imgs)
        colmap.write_points3d_text(os.path.join(d, "points3D.txt"), points, rgb)
    if head is not None:
        flame = os.path.join(root, "flame_fitting", "stage1")
        os.makedirs(os.path.join(flame, "stage_3"), exist_ok=True)
        os.makedirs(os.path.join(flame, "scalp_data"), exist_ok=True)
        mesh_util.save_obj(os.path.join(flame, "stage_3", "mesh_final.obj"),
                           head.verts, head.faces)
        center = head.verts.mean(axis=0)
        scalp = cap_mesh(head, center)
        mesh_util.save_obj(os.path.join(flame, "scalp_data", "scalp.obj"),
                           scalp.verts, scalp.faces)


def toy_views(cameras):
    """Ground truth for a small pipeline scene without a renderer: per view
    a striped RGB image (a different stripe angle each view) with mild
    noise, a hair disc above the centre and a full body mask, as uint8
    ([V, H, W, 3], [V, H, W], [V, H, W])."""
    rng = np.random.default_rng(0)
    imgs, hair, body = [], [], []
    for i, c in enumerate(cameras):
        yy, xx = np.mgrid[0:c.height, 0:c.width]
        a = 0.3 + 0.2 * i
        wave = 0.5 + 0.4 * np.sin(0.6 * (np.cos(a) * xx + np.sin(a) * yy))
        img = np.stack([wave, wave * 0.8, 1 - wave], -1)
        img = img + rng.normal(0, 0.02, img.shape)
        imgs.append(np.clip(img * 255, 0, 255).astype(np.uint8))
        disc = (xx - c.width / 2) ** 2 + (yy - c.height / 2.5) ** 2 < (min(c.width, c.height) / 4) ** 2
        hair.append((disc * 255).astype(np.uint8))
        body.append(np.full((c.height, c.width), 255, np.uint8))
    return np.stack(imgs), np.stack(hair), np.stack(body)


def toy_pipeline_scene(root: str) -> None:
    """A pipeline input scene small enough for the CPU: three 64 x 64
    views on the bench ring (``toy_views`` ground truth), a bench blob of
    400 points and a 10 x 8 sphere as the head."""
    sc = bench_scene(400, 64, 64, 3)
    write_pipeline_scene(root, sc.train_cameras, *toy_views(sc.train_cameras),
                         sc.points, sc.colors, head=sphere_mesh(n_lat=8, n_lon=10))
