"""Unstructured 3DGS model (port of
``gaussianhaircut_tpu/models/gaussian_model.py``; reference
src/scene/gaussian_model.py:28-741).

Parameters keep the JAX package's fixed slot capacity ``C`` with an ``alive``
mask: dead slots render as invalid and receive zero gradient, and
densification fills free slots (train/densify.py).  Activations match the
reference: scaling=exp, opacity/label=sigmoid, rotation=L2-normalize,
orient_conf=exp (clamped to [-30, 30] before the exp).
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from gaussianhaircut_torch.ops import sh as sh_ops
from gaussianhaircut_torch.ops.knn import mean_knn_sq_dist
from gaussianhaircut_torch.records import TensorRecord
from gaussianhaircut_torch.scene import ply as ply_io


def inverse_sigmoid(x: float) -> float:
    return math.log(x / (1 - x))


@dataclasses.dataclass
class GaussianParams(TensorRecord):
    """Learnable parameters, capacity-padded [C, ...]."""
    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    scaling: torch.Tensor        # [C, 3] log-scale
    rotation: torch.Tensor       # [C, 4] unnormalized quat (w, x, y, z)
    opacity: torch.Tensor        # [C, 1] logit
    label: torch.Tensor          # [C, 1] logit
    orient_conf: torch.Tensor    # [C, 1] log
    viewspace: torch.Tensor      # [C, 3] zeros; gradient port of the NDC means


@dataclasses.dataclass
class GaussianAux(TensorRecord):
    """Non-learnable model state."""
    alive: torch.Tensor           # [C] bool
    max_radii2d: torch.Tensor     # [C] float
    xyz_grad_accum: torch.Tensor  # [C] float
    denom: torch.Tensor           # [C] float


@dataclasses.dataclass
class GaussianModelState:
    params: GaussianParams
    aux: GaussianAux
    active_sh_degree: int
    max_sh_degree: int
    spatial_lr_scale: float

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    def num_alive(self) -> int:
        return int(self.aux.alive.sum())

    def replace(self, **changes) -> "GaussianModelState":
        return dataclasses.replace(self, **changes)


# ------------------------------------------------------------- activations --

def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_label(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.label)


def get_orient_conf(p: GaussianParams) -> torch.Tensor:
    return torch.exp(torch.clamp(p.orient_conf, -30.0, 30.0))


def get_features(p: GaussianParams) -> torch.Tensor:
    """[C, K, 3] SH coefficients (dc first)."""
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def _empty_aux(alive: torch.Tensor) -> GaussianAux:
    z = torch.zeros(alive.shape[0], dtype=torch.float32, device=alive.device)
    return GaussianAux(alive=alive, max_radii2d=z, xyz_grad_accum=z.clone(),
                       denom=z.clone())


# ------------------------------------------------------------------- init ---

def create_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                    max_sh_degree: int, spatial_lr_scale: float,
                    device) -> GaussianModelState:
    """Initialize from a point cloud (gaussian_model.py:399-424):
    scales = log sqrt(mean sq dist to 3-NN), opacity = 0.1, label = 0.5."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"capacity {capacity} < initial points {n}")
    k = (max_sh_degree + 1) ** 2
    f32 = dict(dtype=torch.float32, device=device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    dist2 = torch.clamp(mean_knn_sq_dist(pts), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((capacity - n,) + tuple(x.shape[1:]),
                                        fill, **f32)], 0)

    f_dc = sh_ops.rgb2sh(torch.as_tensor(np.asarray(colors, np.float32),
                                         device=device))[:, None, :]
    rot = torch.zeros((capacity, 4), **f32)
    rot[:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(pts),
        features_dc=pad(f_dc),
        features_rest=torch.zeros((capacity, k - 1, 3), **f32),
        scaling=pad(scales),
        rotation=rot,
        opacity=torch.full((capacity, 1), inverse_sigmoid(0.1), **f32),
        label=torch.full((capacity, 1), inverse_sigmoid(0.5), **f32),
        orient_conf=torch.zeros((capacity, 1), **f32),
        viewspace=torch.zeros((capacity, 3), **f32),
    )
    alive = torch.arange(capacity, device=device) < n
    return GaussianModelState(params, _empty_aux(alive), 0, max_sh_degree,
                              float(spatial_lr_scale))


def state_from_numpy(params: dict, aux: dict, active_sh_degree: int,
                     max_sh_degree: int, spatial_lr_scale: float,
                     device) -> GaussianModelState:
    """Carry a model state across from plain dicts of numpy arrays keyed by
    the field names of ``GaussianParams`` / ``GaussianAux`` (for example the
    JAX package's NamedTuples turned into dicts)."""
    p = GaussianParams(**{n: torch.as_tensor(np.array(params[n], np.float32),
                                             device=device)
                          for n in GaussianParams.names()})
    a = {n: torch.as_tensor(np.array(aux[n], np.float32), device=device)
         for n in GaussianAux.names() if n != "alive"}
    a["alive"] = torch.as_tensor(np.array(aux["alive"], bool), device=device)
    return GaussianModelState(p, GaussianAux(**a), int(active_sh_degree),
                              int(max_sh_degree), float(spatial_lr_scale))


# ---------------------------------------------------------------- PLY I/O ---

def save_ply(state: GaussianModelState, path: str) -> None:
    """Write raw_<name> (with label) and <name> (without label) next to each
    other, as gaussian_model.py:479-514 does.  Only alive rows are
    exported."""
    p = state.params
    idx = torch.nonzero(state.aux.alive)[:, 0]
    rows = lambda t: t.detach()[idx].cpu().numpy()
    xyz = rows(p.xyz)
    n = xyz.shape[0]
    f_dc = rows(p.features_dc).transpose(0, 2, 1).reshape(n, -1)
    f_rest = rows(p.features_rest).transpose(0, 2, 1).reshape(n, -1)
    opac, oconf, label = rows(p.opacity), rows(p.orient_conf), rows(p.label)
    scale, rot = rows(p.scaling), rows(p.rotation)

    def fields(with_label):
        names = ["x", "y", "z", "nx", "ny", "nz"]
        names += [f"f_dc_{i}" for i in range(f_dc.shape[1])]
        names += [f"f_rest_{i}" for i in range(f_rest.shape[1])]
        names += ["opacity", "orient_conf"]
        if with_label:
            names.append("label_0")
        names += [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)]
        return names

    def build(with_label):
        cols = [xyz, np.zeros_like(xyz), f_dc, f_rest, opac, oconf]
        if with_label:
            cols.append(label)
        cols += [scale, rot]
        data = np.concatenate(cols, axis=1).astype(np.float32)
        v = np.empty(n, dtype=[(f, "<f4") for f in fields(with_label)])
        for i, f in enumerate(fields(with_label)):
            v[f] = data[:, i]
        return v

    d = os.path.dirname(path)
    name = os.path.basename(path)
    ply_io.write_ply(os.path.join(d, f"raw_{name}"), build(True))
    ply_io.write_ply(path, build(False))


def load_ply(path: str, capacity: int, max_sh_degree: int,
             spatial_lr_scale: float = 1.0, device=None) -> GaussianModelState:
    """Load a (raw_)point_cloud.ply in the reference layout
    (gaussian_model.py:521-579): rows past the file's are dead slots with
    opacity -10 and rotation w = 1; a capacity below the row count becomes
    the row count rounded up to 256.  All SH degrees are active."""
    v = ply_io.read_ply(path)["vertex"]
    n = len(v)
    if capacity < n:
        capacity = -(-n // 256) * 256
    k = (max_sh_degree + 1) ** 2
    names = v.dtype.names
    col = lambda name: np.asarray(v[name], np.float32)[:, None]
    stack = lambda fs: np.stack([v[f] for f in fs], -1).astype(np.float32)
    zeros = np.zeros((n, 1), np.float32)

    xyz = stack(["x", "y", "z"])
    oconf = col("orient_conf") if "orient_conf" in names else zeros
    label = col("label_0") if "label_0" in names else zeros
    f_dc = stack([f"f_dc_{i}" for i in range(3)])[:, None, :]
    rest_names = sorted((x for x in names if x.startswith("f_rest_")),
                        key=lambda x: int(x.split("_")[-1]))
    f_rest = (stack(rest_names).reshape(n, 3, k - 1).transpose(0, 2, 1)
              if rest_names else np.zeros((n, k - 1, 3), np.float32))

    def pad(x, fill=0.0):
        return np.concatenate(
            [x, np.full((capacity - n,) + x.shape[1:], fill, np.float32)], 0)

    rot = pad(stack([f"rot_{i}" for i in range(4)]))
    rot[n:, 0] = 1.0
    params = {"xyz": pad(xyz), "features_dc": pad(f_dc), "features_rest": pad(f_rest),
              "scaling": pad(stack([f"scale_{i}" for i in range(3)])),
              "rotation": rot, "opacity": pad(col("opacity"), fill=-10.0),
              "label": pad(label), "orient_conf": pad(oconf),
              "viewspace": np.zeros((capacity, 3), np.float32)}
    zero = np.zeros(capacity, np.float32)
    aux = {"alive": np.arange(capacity) < n, "max_radii2d": zero,
           "xyz_grad_accum": zero, "denom": zero}
    return state_from_numpy(params, aux, max_sh_degree, max_sh_degree,
                            spatial_lr_scale, device)


# ------------------------------------------------------------- checkpoints --

def capture(state: GaussianModelState) -> dict:
    """Checkpoint dict of numpy arrays (params.*, aux.*, the SH degrees and
    the spatial lr scale); the trainer saves the optimizer alongside."""
    out = {f"params.{n}": v.detach().cpu().numpy()
           for n, v in zip(GaussianParams.names(), state.params.values())}
    out.update({f"aux.{n}": v.cpu().numpy()
                for n, v in zip(GaussianAux.names(), state.aux.values())})
    out["active_sh_degree"] = np.asarray(state.active_sh_degree)
    out["max_sh_degree"] = np.asarray(state.max_sh_degree)
    out["spatial_lr_scale"] = np.asarray(state.spatial_lr_scale)
    return out


def restore(d: dict, device) -> GaussianModelState:
    strip = lambda pre: {k.split(".", 1)[1]: v for k, v in d.items()
                         if k.startswith(pre)}
    return state_from_numpy(strip("params."), strip("aux."),
                            int(d["active_sh_degree"]), int(d["max_sh_degree"]),
                            float(d["spatial_lr_scale"]), device)
