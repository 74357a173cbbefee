"""The reference renderer: the per-Gaussian precompute, the 10-channel
colour assembly and the channel decode (GaussianHaircut's
``gaussian_renderer/__init__.py:23-214``).

Channels: rgb (3) | label (1) | 1 (1) | 2D direction (3) | orientation
confidence (1) | view depth (1).  The orientation angle is
acos(clamp(dir_y, +-(1 - 1e-3)) * sign(dir_x)) / pi of the normalised
composited direction.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from reference import geometry as geo
from reference import raster


@dataclasses.dataclass
class Fields:
    """Activated per-Gaussian fields."""
    xyz: torch.Tensor          # [P, 3]
    features: torch.Tensor     # [P, K, 3]
    scaling: torch.Tensor      # [P, 3]
    rotation: torch.Tensor     # [P, 3, 3]
    opacity: torch.Tensor      # [P, 1]
    label: torch.Tensor        # [P, 1]
    orient_conf: torch.Tensor  # [P, 1]
    valid: torch.Tensor        # [P] bool
    viewspace: torch.Tensor    # [P, 3]: zero, a port for the NDC means' gradient
    use_direction: torch.Tensor | None = None

    @staticmethod
    def cat(a: "Fields", b: "Fields") -> "Fields":
        return Fields(**{f.name: torch.cat([getattr(a, f.name), getattr(b, f.name)])
                         for f in dataclasses.fields(Fields)})


def background(white: bool, device) -> torch.Tensor:
    rgb = 1.0 if white else 0.0
    return torch.tensor([rgb] * 3 + [0.0] * 6 + [100.0], device=device)


def prepare(f: Fields, sh_degree: int, cam: geo.Camera):
    """-> (mean_pix, cov2d, conic, opacity [P], colours [P, 10], depth, ndc)."""
    ndc, cov2d, conic, depth, dir2d = geo.splat_geometry(f.xyz, f.scaling, f.rotation, cam)
    ndc = ndc + f.viewspace
    rgb = geo.sh_colour(f.features, geo.normalize(f.xyz - cam.campos[None]), sh_degree)
    conf = f.orient_conf
    if f.use_direction is not None:
        dir2d = dir2d * f.use_direction[:, None]
        conf = conf * f.use_direction[:, None]
    colours = torch.cat([rgb, f.label, torch.ones_like(f.label), dir2d, conf, depth[:, None]], -1)
    return (raster.pixel_means(ndc, cam.width, cam.height), cov2d, conic, f.opacity[:, 0],
            colours, depth, ndc)


def render(f: Fields, sh_degree: int, cam: geo.Camera, bg, tile: int = 32) -> dict:
    mean_pix, cov2d, conic, opacity, colours, depth, _ = prepare(f, sh_degree, cam)
    binning = raster.bin_gaussians(mean_pix.detach(), cov2d.detach(), depth.detach(), f.valid,
                                   cam.width, cam.height, tile)
    image, t_final = raster.composite(mean_pix, conic, opacity, colours, binning, bg,
                                      cam.width, cam.height, tile)
    d = image[5:7]
    dn = d / torch.sqrt(torch.clamp(torch.sum(d * d, 0, keepdim=True), min=1e-24))
    mirror = torch.where(dn[0:1] < 0, -1.0, 1.0)
    angle = torch.arccos(torch.clamp(dn[1:2], -1 + 1e-3, 1 - 1e-3) * mirror) / math.pi
    return {"render": image[0:3], "mask": image[3:5], "orient_angle": angle,
            "orient_conf": image[8:9], "final_T": t_final, "radii": binning.radius,
            "visible": binning.radius > 0, "instances": len(binning.gid)}


def count_work(f: Fields, sh_degree: int, cam: geo.Camera, tile: int = 32) -> dict:
    """The compositing work these inputs need (no gradient): blended pairs,
    Gaussians with a blended pair, pixels, binned instances, Gaussians."""
    with torch.no_grad():
        mean_pix, cov2d, conic, opacity, colours, depth, _ = prepare(f, sh_degree, cam)
        binning = raster.bin_gaussians(mean_pix, cov2d, depth, f.valid, cam.width,
                                       cam.height, tile)
        pairs, used = raster.count_pairs(mean_pix, conic, opacity, colours, binning, tile)
    return {"pairs": pairs, "gaussians_blended": used, "pixels": cam.width * cam.height,
            "instances": len(binning.gid), "gaussians": int(f.xyz.shape[0])}
