"""Optimizable textured strands: a scalp-UV neural texture decoded into
latent strands (port of ``gaussianhaircut_tpu/models/textured_strands.py``;
hair_strands_textured.yaml:7-16, gaussian_model_latent_strands.py:72-78,
442-453).

- a learnable texture over the scalp's UV chart, ``texture_size``^2 x (64
  geometry + 65 appearance) channels;
- each step picks ``num_strands`` roots from a fixed pool of scalp samples,
  reads their descriptors bilinearly, decodes the geometry codes into local
  polylines (``StrandDecoder``, divided by ``scale_decoder``) and places them
  through per-root tangent frames: p_world = origin + l2w @ p_local;
- the appearance descriptor's first channel is the hair label, the other 64
  feed the colour decoder.

The scalp pool is sampled on the host from numpy's ``default_rng(seed)`` in
the JAX package's order, so both packages build the same pool from a seed.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gaussianhaircut_torch.models.strand_prior import (
    GEOMETRY_DIM, STRAND_LENGTH, StrandDecoder, StrandEncoder, points_from_segments,
)
from gaussianhaircut_torch.utils import mesh as mesh_util


@dataclasses.dataclass(frozen=True)
class TexturedStrandsConfig:
    """hair_strands_textured.yaml:7-16."""
    num_strands: int = 10_000
    max_num_strands: int = 50_000
    texture_size: int = 256
    geometry_descriptor_size: int = GEOMETRY_DIM
    appearance_descriptor_size: int = 65
    strand_length: int = STRAND_LENGTH
    sh_degree: int = 3
    scale_decoder: float = 100.0     # local-frame normalization constant
    diffusion_input: int = 32
    use_diffusion: bool = False
    num_guiding_strands: int = 1000
    pool_size: int = 200_000         # pre-sampled scalp root candidates


class ScalpPool(NamedTuple):
    """Scalp root candidates, sampled once on the host."""
    origins: torch.Tensor       # [S, 3]
    uvs: torch.Tensor           # [S, 2] in [0, 1]
    local2world: torch.Tensor   # [S, 3, 3]

    def to(self, device) -> "ScalpPool":
        return ScalpPool(*(t.to(device) for t in self))

    @staticmethod
    def from_mesh(mesh: mesh_util.Mesh, pool_size: int, seed: int = 0,
                  scalp_vert_ids=None) -> "ScalpPool":
        rng = np.random.default_rng(seed)
        if scalp_vert_ids is not None:
            keep = np.zeros(len(mesh.verts), bool)
            keep[np.asarray(scalp_vert_ids)] = True
            fmask = keep[mesh.faces].all(axis=1)
            mesh = mesh_util.Mesh(mesh.verts, mesh.faces[fmask], mesh.uvs,
                                  mesh.face_uvs[fmask] if mesh.face_uvs is not None else None)
        pts, fidx, bary = mesh_util.sample_surface(mesh, pool_size, rng)
        if mesh.uvs is not None and mesh.face_uvs is not None:
            uvs = mesh_util.interpolate_uv(mesh, fidx, bary)
        else:
            # an area-preserving planar projection of the scalp
            ext_min = mesh.verts.min(0)
            ext = mesh.verts.max(0) - ext_min
            uvs = (pts[:, [0, 2]] - ext_min[[0, 2]]) / np.maximum(ext[[0, 2]], 1e-9)
        frames = mesh_util.tangent_frames(mesh, fidx)
        return _pool(pts, np.clip(uvs, 0, 1), frames)

    @staticmethod
    def from_flame_dir(flame_mesh_dir: str, data_dir: str, cfg,
                       seed: int = 0) -> "ScalpPool":
        """The FLAME-fitting scalp: ``scalp_data/scalp.obj``, or
        ``head_prior.obj`` / ``stage_3/mesh_final.obj`` cut by
        ``scalp_data/cut_scalp_verts.pickle``."""
        candidates = [os.path.join(flame_mesh_dir, "scalp_data", "scalp.obj"),
                      os.path.join(flame_mesh_dir, "head_prior.obj"),
                      os.path.join(flame_mesh_dir, "stage_3", "mesh_final.obj")]
        path = next((c for c in candidates if os.path.exists(c)), None)
        if path is None:
            raise FileNotFoundError(f"no scalp mesh under {flame_mesh_dir}")
        mesh = mesh_util.load_obj(path)
        ids = None
        cut = os.path.join(flame_mesh_dir, "scalp_data", "cut_scalp_verts.pickle")
        if "scalp" not in os.path.basename(path) and os.path.exists(cut):
            with open(cut, "rb") as f:
                ids = pickle.load(f)
        return ScalpPool.from_mesh(mesh, cfg.pool_size, seed, ids)


def _pool(pts, uvs, frames) -> ScalpPool:
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return ScalpPool(f32(pts), f32(uvs), f32(frames))


class StrandsOutput(NamedTuple):
    points: torch.Tensor        # [N, L, 3] world
    p_local: torch.Tensor       # [N, L, 3] local (decoder frame)
    uvs: torch.Tensor           # [N, 2]
    local2world: torch.Tensor   # [N, 3, 3]
    z_geom: torch.Tensor        # [N, 64]
    z_app: torch.Tensor         # [N, app-1] appearance code
    label: torch.Tensor         # [N] first appearance channel


class StrandParams(nn.Module):
    """The textured strands' parameters: the texture and the strand decoder
    (the JAX package's ``init_params`` dict), to which stage 2 adds the
    colour decoder and, with a self-trained prior, the denoiser."""

    def __init__(self, texture: torch.Tensor, decoder: StrandDecoder,
                 color_decoder: nn.Module | None = None,
                 denoiser: nn.Module | None = None):
        super().__init__()
        self.texture = nn.Parameter(texture)
        self.decoder = decoder
        self.color_decoder = color_decoder
        self.denoiser = denoiser


def init_params(cfg: TexturedStrandsConfig, generator: torch.Generator) -> StrandParams:
    """Decoder (flax init) and texture 0.01 x normal (textured_strands.py:125),
    drawn from ``generator`` in that order."""
    decoder = StrandDecoder(length=cfg.strand_length).init_weights(generator)
    c = cfg.geometry_descriptor_size + cfg.appearance_descriptor_size
    texture = 0.01 * torch.randn((cfg.texture_size, cfg.texture_size, c),
                                 generator=generator, device=generator.device)
    return StrandParams(texture, decoder)


def sample_texture(texture: torch.Tensor, uvs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a [T, T, C] texture at uv in [0, 1]^2 -> [N, C]."""
    t = texture.shape[0]
    xy = uvs * (t - 1)
    x0 = torch.clamp(torch.floor(xy).to(torch.int64), 0, t - 2)
    frac = torch.clamp(xy - x0, 0.0, 1.0)
    fx, fy = frac[:, 0:1], frac[:, 1:2]
    c00 = texture[x0[:, 1], x0[:, 0]]
    c01 = texture[x0[:, 1], x0[:, 0] + 1]
    c10 = texture[x0[:, 1] + 1, x0[:, 0]]
    c11 = texture[x0[:, 1] + 1, x0[:, 0] + 1]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_roots(pool: ScalpPool, n: int, generator: torch.Generator) -> torch.Tensor:
    """n distinct pool indices (``jax.random.choice(..., replace=False)``'s
    role; the streams differ)."""
    return torch.randperm(pool.origins.shape[0], generator=generator,
                          device=generator.device)[:n].to(pool.origins.device)


def generate_strands(params: StrandParams, pool: ScalpPool,
                     cfg: TexturedStrandsConfig, roots: torch.Tensor) -> StrandsOutput:
    """Strands rooted at the pool entries ``roots`` [N] (the forward(iter) /
    forward_inference(n) of gaussian_model_latent_strands.py:442-453)."""
    origins = pool.origins[roots]
    uvs = pool.uvs[roots]
    l2w = pool.local2world[roots]
    z = sample_texture(params.texture, uvs)
    g = cfg.geometry_descriptor_size
    z_geom, label, z_app = z[:, :g], z[:, g], z[:, g + 1:]
    segs_local = params.decoder(z_geom) / cfg.scale_decoder
    p_local = points_from_segments(torch.zeros_like(origins)[:, None, :], segs_local)
    world = origins[:, None, :] + torch.einsum("nij,nlj->nli", l2w, p_local)
    return StrandsOutput(world, p_local, uvs, l2w, z_geom, z_app, label)


def encode_strands(encoder: StrandEncoder, p_local: torch.Tensor,
                   cfg: TexturedStrandsConfig) -> torch.Tensor:
    """The frozen encoder's geometry codes of local strands
    (gaussian_model_strands.py:463)."""
    return encoder(p_local * cfg.scale_decoder)[:, :GEOMETRY_DIM]


def synthetic_scalp_pool(pool_size: int = 50_000, seed: int = 0) -> ScalpPool:
    """A polar-cap scalp of radius 0.1 around (0, 0.05, 0), for runs
    without a FLAME fit."""
    rng = np.random.default_rng(seed)
    u = rng.random(pool_size)
    v = rng.random(pool_size)
    theta = np.arccos(np.clip(1 - 0.5 * u, -1, 1))
    phi = 2 * np.pi * v
    n = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                  np.sin(theta) * np.sin(phi)], -1)
    pts = n * 0.1 + np.array([0, 0.05, 0])
    t = np.cross(np.array([0.0, 1.0, 0.0])[None], n)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-9)
    b = np.cross(n, t)
    return _pool(pts, np.stack([u, v], -1), np.stack([t, b, n], axis=-1))
