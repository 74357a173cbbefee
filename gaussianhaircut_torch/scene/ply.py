"""Minimal PLY reader/writer (numpy structured arrays; no external deps).
A copy of ``gaussianhaircut_tpu/scene/ply.py`` without its C++ fast path:
files written by either package are read by the other.

Supports the subsets the pipeline needs: 'vertex' elements with float/uchar
properties, binary little-endian and ascii, matching the on-disk formats the
reference produces/consumes (gaussian_model.py:479-514, dataset_readers.py:
119-142) so outputs stay interchangeable with the reference tooling.
"""
from __future__ import annotations

import os

import numpy as np

_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}
_NP_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i1": "char",
              "i2": "short", "u2": "ushort", "i4": "int", "u4": "uint"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read a PLY file -> {element_name: structured array}."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, np_dtype)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii").strip().split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    raise NotImplementedError("list properties not supported")
                elements[-1][2].append((tokens[2], _PLY_TO_NP[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        out = {}
        for name, count, props in elements:
            dtype = np.dtype(props)
            if fmt == "binary_little_endian":
                out[name] = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
            elif fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                arr = np.empty(count, dtype=dtype)
                flat = np.array(rows, dtype=np.float64)
                for i, (pname, _) in enumerate(props):
                    arr[pname] = flat[:, i]
                out[name] = arr
            else:
                raise NotImplementedError(f"PLY format {fmt}")
        return out


def write_ply(path: str, vertex: np.ndarray, element_name: str = "vertex") -> None:
    """Write a structured array as a binary little-endian PLY."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0",
              f"element {element_name} {len(vertex)}"]
    for name in vertex.dtype.names:
        kind = vertex.dtype[name].str.lstrip("<>|=")
        header.append(f"property {_NP_TO_PLY[kind]} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(np.ascontiguousarray(vertex).tobytes())


def fetch_point_cloud(path: str):
    """(points [N,3], colors [N,3] in [0,1], normals [N,3]) from a PLY with
    x/y/z, red/green/blue, nx/ny/nz fields (dataset_readers.py:119-125)."""
    v = read_ply(path)["vertex"]
    pts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float64)
    if "red" in v.dtype.names:
        cols = np.stack([v["red"], v["green"], v["blue"]], -1).astype(np.float64) / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in v.dtype.names:
        nrm = np.stack([v["nx"], v["ny"], v["nz"]], -1).astype(np.float64)
    else:
        nrm = np.zeros_like(pts)
    return pts, cols, nrm


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write the (x,y,z,nx,ny,nz,red,green,blue) layout of
    dataset_readers.py:127-142 (rgb in [0,255])."""
    dtype = [(n, "<f4") for n in ("x", "y", "z", "nx", "ny", "nz")] + \
            [(n, "u1") for n in ("red", "green", "blue")]
    v = np.empty(xyz.shape[0], dtype=dtype)
    for i, n in enumerate(("x", "y", "z")):
        v[n] = xyz[:, i]
        v["n" + n] = 0.0
    for i, n in enumerate(("red", "green", "blue")):
        v[n] = np.clip(rgb[:, i], 0, 255).astype(np.uint8)
    write_ply(path, v)
