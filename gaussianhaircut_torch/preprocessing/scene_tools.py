"""Scene-geometry preprocessing (port of ``gaussianhaircut_tpu/preprocessing/
scene_tools.py``): the sphere crop and scale, COLMAP text -> cameras.npz, the
FLAME-intersection filter and the image resize.

- ``scale_scene_into_sphere`` (reference src/preprocessing/
  scale_scene_into_sphere.py:30-70): the iterated median-trim sphere fit
  around confident hair Gaussians, written as ``scale.pickle`` and the
  cropped PLY;
- ``colmap_to_h3ds`` (src/preprocessing/colmap_parsing.py): ``sparse_txt``
  -> ``cameras.npz`` (world_mat_i = K @ E) and ``point_cloud.ply``;
- ``filter_flame_intersections`` (src/preprocessing/
  filter_flame_intersections.py:88-121): drops hair Gaussians whose
  icosphere proxies fall inside the FLAME head, by the generalized winding
  number (``mesh_sdf_sign``, torch float64 on the device);
- ``resize_images`` (src/preprocessing/resize_images.py): ``images_2/_4``,
  ``masks_2/_4`` by PIL's Lanczos resample, byte for byte.

The functions that touch tensors run on CUDA unless given ``device="cpu"``.
"""
from __future__ import annotations

import math
import os
import pickle

import numpy as np
import torch

from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.ops.quaternion import build_rotation
from gaussianhaircut_torch.scene import colmap as colmap_io
from gaussianhaircut_torch.scene import ply as ply_io
from gaussianhaircut_torch.scene.dataset import _resize_uint8
from gaussianhaircut_torch.utils import mesh as mesh_util
from gaussianhaircut_torch.utils.image import read_png, write_png


def robust_sphere_fit(xyz_hair: np.ndarray, iters: int = 5):
    """(translation [3], scale) by the reference's iterated median trim
    (scale_scene_into_sphere.py:47-58), in numpy's arithmetic: the first
    pass in float64 around the origin, then in the points' dtype."""
    if xyz_hair.shape[0] == 0:
        raise ValueError("robust_sphere_fit: empty point selection")
    tr = np.zeros(3)
    pts = xyz_hair
    s = 1.0
    for _ in range(iters):
        norm = np.linalg.norm(pts - tr, axis=-1)
        threshold = np.median(norm) * 5
        keep = norm < threshold
        if not keep.any():
            break
        pts = pts[keep]
        tr = pts.mean(axis=0)
        s = norm[keep].max()
    return tr, float(s)


# the selection cascade of scale_scene_into_sphere, strongest first
SPHERE_TIERS = ("alive, label >= 0.5 and opacity >= 0.5", "alive and label >= 0.5", "alive")


def scale_scene_into_sphere(model_path: str, data_path: str, iteration: int,
                            sh_degree: int = 3, device=None) -> dict:
    """Crop the stage-1 model to the hair sphere: writes
    ``point_cloud_cropped/iteration_<it>/`` and ``scale.pickle`` (the
    stage-2/3 scene-scale contract).  Returns the pickle's dict plus the
    selection tier taken (``tier``, an index into ``SPHERE_TIERS``)."""
    device = resolve_device(device)
    src = os.path.join(model_path, "point_cloud", f"iteration_{iteration}",
                       "raw_point_cloud.ply")
    state = gm.load_ply(src, 0, sh_degree, device=device)
    p = state.params
    alive = state.aux.alive.cpu().numpy()
    labels = gm.get_label(p)[:, 0].cpu().numpy()
    opac = gm.get_opacity(p)[:, 0].cpu().numpy()
    xyz = p.xyz.cpu().numpy()

    # the reference assumes a converged stage-1 model with confident hair
    # labels; an undertrained one may have no Gaussian passing both
    # thresholds, so weaker selections follow, and the one taken is logged
    selections = (alive & (labels >= 0.5) & (opac >= 0.5), alive & (labels >= 0.5), alive)
    tier = next((i for i, sel in enumerate(selections) if sel.any()), len(selections) - 1)
    hair = selections[tier]
    print(f"[scale_scene_into_sphere] tier {tier} ({SPHERE_TIERS[tier]}): "
          f"{int(hair.sum())} of {int(alive.sum())} Gaussians")
    tr, s = robust_sphere_fit(xyz[hair])

    keep = alive & (np.linalg.norm(xyz - tr, axis=-1) < s)
    state = state.replace(aux=state.aux.replace(alive=torch.as_tensor(keep, device=device)))
    out_dir = os.path.join(model_path, "point_cloud_cropped", f"iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    gm.save_ply(state, os.path.join(out_dir, "point_cloud.ply"))

    d = {"scale": s, "translation": [float(v) for v in tr]}
    os.makedirs(data_path, exist_ok=True)
    with open(os.path.join(data_path, "scale.pickle"), "wb") as f:
        pickle.dump(d, f)
    return dict(d, tier=tier)


def colmap_to_h3ds(scene_path: str, images_dir: str = "images_4",
                   sparse_dir: str = "sparse_txt") -> None:
    """COLMAP ``sparse_txt`` -> ``cameras.npz`` (world_mat_i = K @ E, for
    the images present in ``images_dir``, sorted by name) and
    ``point_cloud.ply`` (colmap_parsing.py)."""
    sp = os.path.join(scene_path, sparse_dir)
    cams = colmap_io.read_cameras_text(os.path.join(sp, "cameras.txt"))
    imgs = colmap_io.read_images_text(os.path.join(sp, "images.txt"))
    xyz, rgb, _ = colmap_io.read_points3d_text(os.path.join(sp, "points3D.txt"))

    cam = next(iter(cams.values()))
    if cam.model == "PINHOLE":
        fx, fy, x0, y0 = cam.params[:4]
    else:  # SIMPLE_PINHOLE
        fx, x0, y0 = cam.params[:3]
        fy = fx
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, x0, y0

    data = {}
    for img in imgs.values():
        E = np.eye(4)
        E[:3, :3] = colmap_io.qvec_to_rotmat(img.qvec)
        E[:3, 3] = img.tvec
        data[img.name] = K @ E

    images_folder = os.path.join(scene_path, images_dir)
    names = [n for n in data if os.path.exists(os.path.join(images_folder, n))]
    out = {}
    for i, name in enumerate(sorted(names)):
        out[f"world_mat_{i}"] = data[name]
        out[f"scale_mat_{i}"] = np.eye(4)
    np.savez(os.path.join(scene_path, "cameras.npz"), **out)
    ply_io.store_point_cloud(os.path.join(scene_path, "point_cloud.ply"),
                             xyz, rgb.astype(np.float64))


# ------------------------------------------------------------------ SDF ----

CHUNK_TERMS = 1 << 24     # point-face terms per chunk of the winding number


@torch.no_grad()
def winding_numbers(points, mesh: mesh_util.Mesh, device=None) -> torch.Tensor:
    """Generalized winding number of ``points`` [N, 3] (numpy or torch)
    with respect to the triangles of ``mesh``, in float64 on ``device``
    (CUDA by default): the sum over faces of the solid angle
    2 atan2(a . (b x c), |a||b||c| + (a.b)|c| + (b.c)|a| + (a.c)|b|), over
    4 pi (Van Oosterom and Strackee).  The point-face terms go in chunks of
    about ``CHUNK_TERMS`` (~150 bytes each at the peak)."""
    device = resolve_device(device)
    tri = torch.as_tensor(np.asarray(mesh.verts, np.float64)[np.asarray(mesh.faces)],
                          device=device)                                   # [F, 3, 3]
    pts = torch.as_tensor(points).to(device=device, dtype=torch.float64)
    n_faces = tri.shape[0]
    corner = [[tri[None, :, v, i] for i in range(3)] for v in range(3)]   # [1, F] each
    step = max(1, CHUNK_TERMS // max(n_faces, 1))
    wn = torch.empty(pts.shape[0], dtype=torch.float64, device=device)
    for s in range(0, pts.shape[0], step):
        p = pts[s:s + step, :, None]                                       # [n, 3, 1]
        a, b, c = ([corner[v][i] - p[:, i] for i in range(3)] for v in range(3))
        la, lb, lc = (torch.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]) for x in (a, b, c))
        num = (a[0] * (b[1] * c[2] - b[2] * c[1]) + a[1] * (b[2] * c[0] - b[0] * c[2])
               + a[2] * (b[0] * c[1] - b[1] * c[0]))
        dot = lambda x, y: x[0] * y[0] + x[1] * y[1] + x[2] * y[2]
        den = la * lb * lc + dot(a, b) * lc + dot(b, c) * la + dot(a, c) * lb
        wn[s:s + step] = (2.0 * torch.atan2(num, den)).sum(dim=1) / (4.0 * math.pi)
    return wn


def mesh_sdf_sign(points, mesh: mesh_util.Mesh, device=None) -> np.ndarray:
    """True where a point is INSIDE the (closed) mesh: winding number
    > 0.5, robust to small gaps (the pysdf-equivalent that
    filter_flame_intersections.py:115-118 needs).  float64 as the JAX
    package's numpy, so the decision is the same away from the surface."""
    return (winding_numbers(points, mesh, device) > 0.5).cpu().numpy()


def icosphere(subdiv: int = 0) -> np.ndarray:
    """Unit icosahedron vertices (the Gaussian proxy shell of
    filter_flame_intersections.py:88-99)."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    return verts / np.linalg.norm(verts, axis=-1, keepdims=True)


@torch.no_grad()
def filter_flame_intersections(model_path: str, flame_mesh_path: str,
                               iteration: int, sh_degree: int = 3,
                               label_threshold: float = 0.1, device=None) -> int:
    """Prune hair Gaussians intersecting the FLAME head: an icosphere proxy
    per Gaussian (vertices scaled by the scales, rotated by the rows of R,
    moved to the mean, in float64), its vertices tested against the head's
    winding number; Gaussians with label >= ``label_threshold`` and an
    inside vertex are dropped (filter_flame_intersections.py:88-121).
    Writes ``point_cloud_filtered/``; returns the number dropped.  Only
    alive rows are tested: the others are not kept either way."""
    device = resolve_device(device)
    src = os.path.join(model_path, "point_cloud_cropped",
                       f"iteration_{iteration}", "raw_point_cloud.ply")
    if not os.path.exists(src):
        src = os.path.join(model_path, "point_cloud",
                           f"iteration_{iteration}", "raw_point_cloud.ply")
    state = gm.load_ply(src, 0, sh_degree, device=device)
    p = state.params
    alive = state.aux.alive
    idx = torch.nonzero(alive)[:, 0]
    is_hair = gm.get_label(p)[idx, 0] >= label_threshold
    scales = gm.get_scaling(p)[idx].double()
    rot = build_rotation(p.rotation[idx]).double()
    ico = torch.as_tensor(icosphere(), device=device)                      # [12, 3]
    # proxy vertices = ico * S @ R + mu (the rows of R are the principal axes)
    proxy = torch.einsum("vk,pk,pkj->pvj", ico, scales, rot) + p.xyz[idx].double()[:, None]

    head = mesh_util.load_obj(flame_mesh_path)
    inside = torch.as_tensor(mesh_sdf_sign(proxy.reshape(-1, 3), head, device),
                             device=device).reshape(idx.shape[0], -1).any(dim=1)
    keep = alive.clone()
    keep[idx] = ~(is_hair & inside)
    state = state.replace(aux=state.aux.replace(alive=keep))
    out_dir = os.path.join(model_path, "point_cloud_filtered", f"iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    gm.save_ply(state, os.path.join(out_dir, "point_cloud.ply"))
    return int((is_hair & inside).sum())


def resize_images(scene_path: str, factors=(2, 4), device=None) -> None:
    """``images_<f>/`` and ``masks_<f>/`` (sub-directories included) at
    1/f of the size, floored, by PIL's Lanczos resample, byte for byte
    (reference resize_images.py); 8-bit PNGs in gray, gray + alpha, RGB or
    RGBA, written in the mode they were read in.  The resample's sums run
    on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    for src_name in ("images", "masks"):
        src = os.path.join(scene_path, src_name)
        if not os.path.isdir(src):
            continue
        walk = ([("", n) for n in sorted(os.listdir(src))
                 if os.path.isfile(os.path.join(src, n))]
                + [(d, n) for d in sorted(os.listdir(src))
                   if os.path.isdir(os.path.join(src, d))
                   for n in sorted(os.listdir(os.path.join(src, d)))])
        for d, n in walk:
            img = read_png(os.path.join(src, d, n))
            for f in factors:
                size = (img.shape[1] // f, img.shape[0] // f)
                write_png(os.path.join(scene_path, f"{src_name}_{f}", d, n),
                          _resize_uint8(img, size, "lanczos", device))
