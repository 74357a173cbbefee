"""The renderer: per-Gaussian differentiable precompute + 10-channel
splatting + channel decoding (port of
``gaussianhaircut_tpu/render/renderer.py``; reference
src/gaussian_renderer/__init__.py:23-214).

Channel layout: [rgb(3) | label(1) | fg=1(1) | dir2d(3) | orient_conf(1) |
view-depth(1)].  Decode: orientation angle = acos(clamp(dir_y, +-(1-1e-3)) *
sign(dir_x)) / pi.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.ops import precompute as precompute_ops
from gaussianhaircut_torch.ops import projection as proj
from gaussianhaircut_torch.ops import sh as sh_ops
from gaussianhaircut_torch.ops.quaternion import build_rotation, normalize
from gaussianhaircut_torch.ops.rasterize.api import rasterize, rasterize_batched
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig


@dataclasses.dataclass
class GaussianFields:
    """Activated per-Gaussian fields, the renderer's input."""
    xyz: torch.Tensor              # [P, 3]
    features: torch.Tensor         # [P, K, 3]
    scaling: torch.Tensor          # [P, 3] activated
    rotation_matrix: torch.Tensor  # [P, 3, 3]
    opacity: torch.Tensor          # [P, 1]
    label: torch.Tensor            # [P, 1]
    orient_conf: torch.Tensor      # [P, 1]
    valid: torch.Tensor            # [P] bool
    viewspace: torch.Tensor        # [P, 3] zero gradient port on the NDC means
    use_direction: torch.Tensor | None = None


class Precomputed(NamedTuple):
    """The precompute's outputs for one camera."""
    ndc: torch.Tensor          # [P, 3]
    conic: torch.Tensor        # [P, 3]
    colors: torch.Tensor       # [P, 10]
    depth: torch.Tensor        # [P]


def precompute(fields: GaussianFields, active_sh_degree: int, cam: proj.CameraGeom,
               scaling_modifier: float = 1.0) -> Precomputed:
    """Each Gaussian's compositing inputs: CUDA fields launch the fused
    kernels (``ops/precompute.py``, which raises on what they do not take),
    CPU fields run ``precompute_plain``."""
    if fields.xyz.is_cuda:
        out = precompute_ops.precompute_cuda(
            fields.xyz, fields.features, fields.scaling, fields.rotation_matrix,
            fields.label, fields.orient_conf, fields.viewspace, fields.use_direction, cam,
            active_sh_degree, scaling_modifier)
        return Precomputed(*out)
    return Precomputed(*precompute_plain(fields, active_sh_degree, cam, scaling_modifier))


def precompute_plain(fields: GaussianFields, active_sh_degree: int,
                     cam: proj.CameraGeom, scaling_modifier: float = 1.0):
    """The precompute as a composition of PyTorch ops, differentiable by
    autograd -> (ndc, conic, colors10, depth); the JAX package's row-major
    body (``prepare_raster_inputs_rowmajor``)."""
    xyz = fields.xyz
    scaling = fields.scaling * scaling_modifier
    rot_m = fields.rotation_matrix

    cov3d = proj.covariance_3d(scaling, rot_m)
    cov2d = proj.covariance_2d(xyz, cov3d, cam)
    conic = proj.conic_from_cov2d(cov2d)
    ndc = proj.project_ndc(xyz, cam.projmatrix) + fields.viewspace
    depth = proj.depths(xyz, cam)

    dirs = normalize(xyz - cam.campos[None, :])
    rgb = torch.clamp(sh_ops.eval_sh(active_sh_degree, fields.features, dirs) + 0.5,
                      min=0.0)
    dir2d = proj.direction_2d(xyz, scaling, rot_m, cam)
    orient_conf = fields.orient_conf
    if fields.use_direction is not None:
        dir2d = dir2d * fields.use_direction[:, None]
        orient_conf = orient_conf * fields.use_direction[:, None]
    colors = torch.cat([rgb, fields.label, torch.ones_like(fields.label), dir2d,
                        orient_conf, depth], dim=-1)
    return ndc, conic, colors, depth[:, 0]


def prepare_raster_inputs(fields: GaussianFields, active_sh_degree: int,
                          cam: proj.CameraGeom, scaling_modifier: float = 1.0):
    """Differentiable precompute -> (ndc, conic, colors10, opacity, depth,
    valid) (``precompute``; opacity and valid pass through)."""
    ndc, conic, colors, depth = precompute(fields, active_sh_degree, cam, scaling_modifier)
    return ndc, conic, colors, fields.opacity, depth, fields.valid


def decode_render10(render10: torch.Tensor) -> dict:
    """Channel decode of a composited [10, H, W] image."""
    dir_r = render10[5:7]
    dir_n2 = torch.sum(dir_r * dir_r, dim=0, keepdim=True)
    dir_n = dir_r / torch.sqrt(torch.clamp(dir_n2, min=1e-24))
    mirror = torch.where(dir_n[0:1] < 0, -1.0, 1.0)
    orient_angle = torch.arccos(
        torch.clamp(dir_n[1:2], -1 + 1e-3, 1 - 1e-3) * mirror) / math.pi
    return {
        "render": render10[0:3],
        "mask": render10[3:5],
        "orient_angle": orient_angle,
        "orient_conf": render10[8:9],
        "depth": render10[9:10],
        "render10": render10,
    }


def render_fields(fields: GaussianFields, active_sh_degree: int,
                  cam: proj.CameraGeom, bg: torch.Tensor,
                  cfg: RasterConfig | None = None,
                  scaling_modifier: float = 1.0) -> dict:
    """Render activated fields through the compositing kernels and decode."""
    pre = precompute(fields, active_sh_degree, cam, scaling_modifier)
    out = rasterize(pre.ndc, pre.conic, pre.colors, fields.opacity, pre.depth, fields.valid,
                    bg, cam.width, cam.height, cfg)
    decoded = decode_render10(out["render"])
    decoded.update({
        "final_T": out["final_T"],
        "visibility_filter": out["visibility"],
        "radii": out["radii"],
        "num_rendered": out["num_rendered"],
        "num_rendered_3sigma": out["num_rendered_3sigma"],
    })
    return decoded


def render_fields_batched(fields: GaussianFields, active_sh_degree: int,
                          cams: list, bg: torch.Tensor, cfg: RasterConfig | None = None,
                          viewspace_batch: torch.Tensor | None = None) -> dict:
    """Batched-camera render: the precompute of each camera of ``cams``
    (``CameraGeom``s of one size), then one ``rasterize_batched`` over all
    of them, and the channel decode.  ``viewspace_batch`` [B, P, 3]
    replaces the viewspace port camera by camera, so that its gradient
    comes back per camera (the densify statistics read each camera's on its
    own).  Returns the decoded dict with a leading [B] axis on every image
    and per-Gaussian output; ``num_rendered`` is the total over cameras."""
    per_cam = []
    for b, cam in enumerate(cams):
        f = (fields if viewspace_batch is None
             else dataclasses.replace(fields, viewspace=viewspace_batch[b]))
        per_cam.append(precompute(f, active_sh_degree, cam))
    ndc, conic, colors, depth = (torch.stack(x) for x in zip(*per_cam))
    opacity, valid = (torch.stack([x] * len(cams)) for x in (fields.opacity, fields.valid))
    out = rasterize_batched(ndc, conic, colors, opacity, depth, valid, bg,
                            cams[0].width, cams[0].height, cfg)
    per_image = [decode_render10(r) for r in out["render"]]
    decoded = {k: torch.stack([d[k] for d in per_image]) for k in per_image[0]}
    decoded.update({
        "final_T": out["final_T"],
        "visibility_filter": out["visibility"],
        "radii": out["radii"],
        "num_rendered": out["num_rendered"],
        "num_rendered_3sigma": out["num_rendered_3sigma"],
    })
    return decoded


def fields_from_params(p: gm.GaussianParams, alive: torch.Tensor) -> GaussianFields:
    return GaussianFields(
        xyz=p.xyz,
        features=gm.get_features(p),
        scaling=gm.get_scaling(p),
        rotation_matrix=build_rotation(p.rotation),
        opacity=gm.get_opacity(p),
        label=gm.get_label(p),
        orient_conf=gm.get_orient_conf(p),
        valid=alive,
        viewspace=p.viewspace,
    )


def render(params: gm.GaussianParams, alive: torch.Tensor,
           active_sh_degree: int, cam: proj.CameraGeom, bg: torch.Tensor,
           cfg: RasterConfig | None = None,
           scaling_modifier: float = 1.0) -> dict:
    """Stage-1 render (gaussian_renderer/__init__.py:23-113)."""
    return render_fields(fields_from_params(params, alive), active_sh_degree,
                         cam, bg, cfg, scaling_modifier)


def default_background(white: bool, device) -> torch.Tensor:
    """[10] background; the depth channel's background is 100."""
    rgb = 1.0 if white else 0.0
    return torch.tensor([rgb, rgb, rgb, 0, 0, 0, 0, 0, 0, 100],
                        dtype=torch.float32, device=device)
