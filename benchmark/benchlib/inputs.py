"""Every input of a run, made from ``--seed``: on the card, in a few large
calls of a ``torch.Generator`` of the run's device.  The same seed gives the
same inputs; each seed draws the same sizes.

Copies of the port's generators, so that a later change to the port cannot
move the yardstick: the bench blob and its ground truth
(``scene/synthetic.bench_scene``), the ring of cameras (``ring_cameras``),
the polar-cap scalp pool (``models/textured_strands.synthetic_scalp_pool``)
and the root draw (``sample_roots``), with the stage-2 loop's diffusion draws
(``train/stage2.draw_stage2``) and the trainers' camera order (shuffled
epochs, one camera drawn at random from what is left of the epoch).
"""
from __future__ import annotations

import hashlib
import math
import random

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def generator(seed: int, stream: str, device) -> torch.Generator:
    """An independent generator per (seed, stream)."""
    h = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(h[:8], "little") & ((1 << 63) - 1))
    return gen


def ring_cameras(n_views: int, radius: float = 2.5, height_y: float = 0.3,
                 fov_deg: float = 50.0) -> dict:
    """``n_views`` cameras evenly on a horizontal ring of ``radius`` at height
    ``height_y`` around the origin, looking at it: column-vector
    world-to-camera transforms and fields of view (numpy).  The bench's ring
    is the default."""
    fov = math.radians(fov_deg)
    w2cs = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        center = np.array([radius * math.sin(a), height_y, radius * math.cos(a)])
        fwd = -center / np.linalg.norm(center)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=0)
        w2c[:3, 3] = -w2c[:3, :3] @ center
        w2cs.append(w2c)
    return {"colmap_transform": np.stack(w2cs), "fovx": np.full(n_views, fov, np.float32),
            "fovy": np.full(n_views, fov, np.float32)}


def cameras(cfg: dict, device) -> dict:
    """The configuration's ring of ``views`` cameras, on ``device``."""
    r = cfg["ring"]
    cams = ring_cameras(cfg["views"], r["radius"], r["height"], r["fov_deg"])
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in cams.items()}


def ground_truth(gen: torch.Generator, n_views: int, width: int, height: int) -> dict:
    """The bench scene's ground truth: uniform images and orientation
    angles, hair mask 0.5, body mask 1, orientation confidence 1."""
    dev = gen.device
    noise = torch.rand((n_views, 4, height, width), generator=gen, device=dev)
    mask = torch.ones((n_views, 2, height, width), device=dev)
    mask[:, 0] = 0.5
    return {"image": noise[:, :3], "mask": mask, "orient_angle": noise[:, 3:4],
            "orient_conf": torch.ones((n_views, 1, height, width), device=dev)}


def knn_scale(xyz: torch.Tensor, count: int, sigma: float) -> torch.Tensor:
    """The expected 3DGS initial scale, sqrt(mean squared distance to the 3
    nearest neighbours), of points drawn N(0, sigma^2 I) ``count`` times:
    for a Poisson process of density rho, E[d_k^2] = Gamma(k + 2/3) /
    Gamma(k) (4 pi rho / 3)^(-2/3)."""
    mean_gamma = sum(math.gamma(k + 2 / 3) / math.gamma(k) for k in (1, 2, 3)) / 3
    r2 = torch.sum(xyz * xyz, -1)
    rho = count * (2 * math.pi * sigma ** 2) ** -1.5 * torch.exp(-r2 / (2 * sigma ** 2))
    d2 = mean_gamma * (4 * math.pi * rho / 3) ** (-2.0 / 3.0)
    return torch.sqrt(torch.clamp(d2, min=1e-7))


def gaussians(gen: torch.Generator, count: int, g: dict) -> dict:
    """A Gaussian population (``g``: the configuration's population entry).

    Centres: ``shape`` ``blob``, N(0, blob_sigma^2) (the bench blob); or
    ``sphere``, uniform on a sphere of ``radius`` around ``center`` with
    N(0, shell_std^2) radial noise (a head's surface).  Log scales around
    the expected 3-nearest-neighbour scale of that density (the 3DGS init)
    with per-axis N(0, scale_log_std^2), each axis capped at ``max_scale``
    where the entry has it; colours U(0.2, 0.8) as SH degree 0,
    higher SH N(0, rest_std^2); uniformly random rotations; opacity logits
    N(logit(opacity), opacity_logit_std^2); label logits N(label_logit, 1);
    log orientation confidences N(0, conf_log_std^2); the viewspace port
    zero."""
    dev = gen.device
    k = (g["sh_degree"] + 1) ** 2
    normal = torch.randn((count, 3 + 3 * (k - 1) + 3 + 4 + 4), generator=gen, device=dev)
    colours = 0.2 + 0.6 * torch.rand((count, 3), generator=gen, device=dev)
    xyz, rest, logs, rot, extra = torch.split(normal, [3, 3 * (k - 1), 3, 4, 4], 1)
    if g["shape"] == "blob":
        xyz = xyz * g["blob_sigma"]
        scale = knn_scale(xyz, count, g["blob_sigma"])
    else:
        r = g["radius"] + g["shell_std"] * extra[:, 3:4]
        xyz = torch.tensor(g["center"], device=dev) + r * xyz / torch.linalg.norm(xyz, dim=1,
                                                                                 keepdim=True)
        # 2D Poisson: mean over k = 1..3 of E[d_k^2] = k / (pi density)
        scale = torch.full((count,), math.sqrt(2 * 4 * g["radius"] ** 2 / count), device=dev)
    log_scale = torch.log(scale)[:, None] + g["scale_log_std"] * logs
    if "max_scale" in g:
        log_scale = torch.clamp(log_scale, max=math.log(g["max_scale"]))
    logit = math.log(g["opacity"] / (1 - g["opacity"]))
    return {"xyz": xyz.contiguous(),
            "features_dc": ((colours - 0.5) / SH_C0)[:, None, :].contiguous(),
            "features_rest": (g["rest_std"] * rest).reshape(count, k - 1, 3).contiguous(),
            "scaling": log_scale.contiguous(),
            "rotation": rot.contiguous(),
            "opacity": (logit + g["opacity_logit_std"] * extra[:, 0:1]).contiguous(),
            "label": (g["label_logit"] + extra[:, 1:2]).contiguous(),
            "orient_conf": (g["conf_log_std"] * extra[:, 2:3]).contiguous(),
            "viewspace": torch.zeros((count, 3), device=dev)}


def scalp_pool(gen: torch.Generator, pool_size: int) -> dict:
    """Root candidates on a polar cap of radius 0.1 around (0, 0.05, 0): uv,
    position and the local frame [tangent, bitangent, normal] (columns)."""
    dev = gen.device
    u, v = torch.rand((2, pool_size), generator=gen, device=dev, dtype=torch.float64)
    theta = torch.arccos(torch.clamp(1 - 0.5 * u, -1, 1))
    phi = 2 * math.pi * v
    n = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                     torch.sin(theta) * torch.sin(phi)], -1)
    pts = n * 0.1 + torch.tensor([0.0, 0.05, 0.0], dtype=torch.float64, device=dev)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=dev).expand_as(n)
    t = torch.linalg.cross(up, n, dim=-1)
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-9)
    b = torch.linalg.cross(n, t, dim=-1)
    f32 = lambda x: x.to(torch.float32).contiguous()
    return {"origins": f32(pts), "uvs": f32(torch.stack([u, v], -1)),
            "local2world": f32(torch.stack([t, b, n], -1))}


def sample_roots(gen: torch.Generator, pool_size: int, n: int) -> torch.Tensor:
    """``n`` distinct pool indices."""
    return torch.randperm(pool_size, generator=gen, device=gen.device)[:n]


def diffusion_draws(gen: torch.Generator, size: int, channels: int, mean: float = -1.2,
                    std: float = 1.2, lo: float = 0.02, hi: float = 40.0) -> tuple:
    """(sigma [1] lognormal(mean, std) clipped to [lo, hi], noise [1, D, D, C])."""
    z = torch.randn((1,), generator=gen, device=gen.device)
    sigma = torch.clamp(torch.exp(mean + std * z), lo, hi)
    return sigma, torch.randn((1, size, size, channels), generator=gen, device=gen.device)


class CameraOrder:
    """The trainers' draw order: a shuffled epoch of all cameras, one drawn
    at random from what is left of it, a fresh epoch when it is spent."""

    def __init__(self, n_views: int, seed: int):
        self.n, self.rng, self.stack = n_views, random.Random(int(seed)), []
        self._next = self._draw()

    def _draw(self) -> int:
        if not self.stack:
            self.stack = list(range(self.n))
            self.rng.shuffle(self.stack)
        return self.stack.pop(self.rng.randrange(len(self.stack)))

    def peek(self) -> int:
        """The camera ``next`` will give."""
        return self._next

    def next(self) -> int:
        out, self._next = self._next, self._draw()
        return out
