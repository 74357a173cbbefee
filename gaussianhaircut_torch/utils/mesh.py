"""Mesh utilities for the scalp and the head: OBJ reading (with UVs) and
writing, area-weighted surface sampling, UV interpolation and tangent
frames (a numpy copy of ``gaussianhaircut_tpu/utils/mesh.py``'s functions
that the textured-strands scalp pool and the pipeline use).
Initialisation-time host code, off the training step."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Mesh(NamedTuple):
    verts: np.ndarray             # [V, 3]
    faces: np.ndarray             # [F, 3] vertex indices
    uvs: np.ndarray | None        # [T, 2]
    face_uvs: np.ndarray | None   # [F, 3] uv indices


def load_obj(path: str) -> Mesh:
    """Vertices, UVs and faces of an OBJ; polygons are fan-triangulated."""
    verts, uvs, faces, face_uvs = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx, tidx = [], []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    idx.append(int(parts[0]) - 1)
                    if len(parts) > 1 and parts[1]:
                        tidx.append(int(parts[1]) - 1)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    if tidx:
                        face_uvs.append([tidx[0], tidx[k], tidx[k + 1]])
    return Mesh(np.asarray(verts, np.float64), np.asarray(faces, np.int64),
                np.asarray(uvs, np.float64) if uvs else None,
                np.asarray(face_uvs, np.int64) if face_uvs else None)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray,
             uvs: np.ndarray | None = None, face_uvs: np.ndarray | None = None) -> None:
    """An OBJ that ``load_obj`` reads back (1-based indices), with ``vt``
    rows and ``v/vt`` faces when ``uvs`` and ``face_uvs`` are given (the
    scalp's ``scalp.obj``)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if uvs is not None:
            for t in uvs:
                f.write(f"vt {t[0]} {t[1]}\n")
        for i, face in enumerate(faces):
            if uvs is not None and face_uvs is not None:
                t = face_uvs[i]
                f.write(f"f {face[0]+1}/{t[0]+1} {face[1]+1}/{t[1]+1} {face[2]+1}/{t[2]+1}\n")
            else:
                f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


def face_areas(mesh: Mesh) -> np.ndarray:
    v = mesh.verts
    a = v[mesh.faces[:, 1]] - v[mesh.faces[:, 0]]
    b = v[mesh.faces[:, 2]] - v[mesh.faces[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(a, b), axis=-1)


def sample_surface(mesh: Mesh, n: int, rng: np.random.Generator):
    """Area-weighted surface sampling -> (points [n, 3], face index [n],
    barycentric coordinates [n, 3]).  Draws in the JAX package's order, so
    one seed gives both packages the same samples."""
    areas = face_areas(mesh)
    fidx = rng.choice(len(areas), size=n, p=areas / areas.sum())
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u[flip] = 1 - u[flip]
    v[flip] = 1 - v[flip]
    bary = np.stack([1 - u - v, u, v], axis=-1)
    pts = np.einsum("nk,nkd->nd", bary, mesh.verts[mesh.faces[fidx]])
    return pts, fidx, bary


def interpolate_uv(mesh: Mesh, fidx: np.ndarray, bary: np.ndarray) -> np.ndarray:
    if mesh.uvs is None or mesh.face_uvs is None:
        raise ValueError("the mesh has no UVs")
    return np.einsum("nk,nkd->nd", bary, mesh.uvs[mesh.face_uvs[fidx]])


def tangent_frames(mesh: Mesh, fidx: np.ndarray) -> np.ndarray:
    """Per-sample local-to-world rotations [n, 3, 3] with columns (tangent,
    bitangent, normal).  The tangent follows the UV u-direction when the
    mesh has UVs, else the face's first edge."""
    tri = mesh.verts[mesh.faces[fidx]]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    if mesh.uvs is not None and mesh.face_uvs is not None:
        uv = mesh.uvs[mesh.face_uvs[fidx]]
        du1 = uv[:, 1] - uv[:, 0]
        du2 = uv[:, 2] - uv[:, 0]
        det = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
        det = np.where(np.abs(det) < 1e-12, 1.0, det)
        t = (du2[:, 1:2] * e1 - du1[:, 1:2] * e2) / det[:, None]
    else:
        t = e1
    t = t - n * np.sum(t * n, axis=-1, keepdims=True)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    b = np.cross(n, t)
    return np.stack([t, b, n], axis=-1)
