"""COLMAP sparse-reconstruction parsers (binary and text) and text writers.
A copy of ``gaussianhaircut_tpu/scene/colmap.py`` without its C++ fast
paths.

Fresh numpy implementation of the COLMAP file formats consumed by the
reference (src/scene/colmap_loader.py:43-293): cameras.bin/txt,
images.bin/txt, points3D.bin/txt.  Only the fields the pipeline uses are
retained.
"""
from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray     # [4] (w, x, y, z)
    tvec: np.ndarray     # [3]
    camera_id: int
    name: str


# COLMAP camera model ids -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_IDS = {name: mid for mid, (name, _) in _CAMERA_MODELS.items()}


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> COLMAP (w, x, y, z) quaternion (largest-component safe)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[i + 1] = 0.25 * s
        q[j + 1] = (R[j, i] + R[i, j]) / s
        q[k + 1] = (R[k, i] + R[i, k]) / s
    if q[0] < 0:
        q = -q
    return q


def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, nparams = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * nparams))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            cams[cid] = ColmapCamera(cid, parts[1], int(parts[2]), int(parts[3]),
                                     np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (npts,) = _read(f, "<Q")
            f.read(24 * npts)  # skip 2D points (x, y, point3D_id)
            imgs[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode("utf-8"))
    return imgs


def _is_meta_line(parts: list[str]) -> bool:
    """IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME — 10 fields, last one a
    filename; a POINTS2D row is 3N numeric fields (X Y POINT3D_ID)*."""
    if len(parts) != 10:
        return False
    try:
        float(parts[9])
        return False
    except ValueError:
        return True


def read_images_text(path: str) -> dict[int, ColmapImage]:
    """COLMAP alternates a meta line with a POINTS2D line that is EMPTY for
    images without observations (colmap_loader-style readers consume it
    positionally) — so blank lines must not be pre-filtered, or every image
    after a zero-observation one lands on the wrong parity."""
    imgs = {}
    expecting_points = False
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("#"):
                continue
            parts = s.split()
            if expecting_points:
                # normally the POINTS2D row (possibly empty) — but tolerate
                # writers that omit it entirely by sniffing meta lines
                if not _is_meta_line(parts):
                    expecting_points = False
                    continue
            elif not s:
                continue
            iid = int(parts[0])
            qvec = np.array([float(p) for p in parts[1:5]])
            tvec = np.array([float(p) for p in parts[5:8]])
            imgs[iid] = ColmapImage(iid, qvec, tvec, int(parts[8]), parts[9])
            expecting_points = True
    return imgs


def read_points3d_binary(path: str):
    """-> (xyz [N,3], rgb [N,3] uint8, err [N])."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            _read(f, "<Q")  # point id
            xyz[i] = _read(f, "<ddd")
            rgb[i] = _read(f, "<BBB")
            err[i] = _read(f, "<d")[0]
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(x) for x in p[1:4]])
            rgb.append([int(x) for x in p[4:7]])
            err.append(float(p[7]))
    return np.array(xyz), np.array(rgb, np.uint8), np.array(err)


def read_model(sparse_dir: str):
    """Read (cameras, images, points) from a COLMAP sparse dir, preferring
    binary (dataset_readers.py:145-154 fallback order)."""
    if os.path.exists(os.path.join(sparse_dir, "images.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
    pts = None
    if os.path.exists(os.path.join(sparse_dir, "points3D.bin")):
        pts = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    elif os.path.exists(os.path.join(sparse_dir, "points3D.txt")):
        pts = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts


def write_cameras_text(path: str, cams: dict[int, ColmapCamera]) -> None:
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(path: str, imgs: dict[int, ColmapImage]) -> None:
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for im in imgs.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n\n")


def write_points3d_text(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """points3D.txt with zero errors and empty tracks (``read_points3d_text``
    reads it)."""
    with open(path, "w") as f:
        f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n")
        f.writelines(f"{i + 1} {p[0]!r} {p[1]!r} {p[2]!r} {c[0]} {c[1]} {c[2]} 0.0\n"
                     for i, (p, c) in enumerate(zip(np.asarray(xyz, np.float64).tolist(),
                                                    np.asarray(rgb, np.uint8).tolist())))


def write_cameras_binary(path: str, cams: dict[int, ColmapCamera]) -> None:
    """The cameras.bin layout ``read_cameras_binary`` reads."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            f.write(struct.pack("<iiQQ", cam.id, _MODEL_IDS[cam.model],
                                cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(path: str, imgs: dict[int, ColmapImage]) -> None:
    """The images.bin layout ``read_images_binary`` reads, with no 2D
    points."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i4d3di", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray,
                          err: np.ndarray) -> None:
    """The points3D.bin layout ``read_points3d_binary`` reads, with empty
    tracks."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<Q3d3BdQ", i + 1, *xyz[i], *rgb[i], err[i], 0))
