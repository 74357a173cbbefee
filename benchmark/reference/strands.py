"""The reference's strand networks, as functions of a dict of weights keyed
by parameter name (NeuralHaircut's textured strands and strand prior, and
the k-diffusion ``image_v1`` UNet with EDM preconditioning, as GaussianHaircut
configures them in ``hair_strands_textured.yaml``; a frozen copy of the
port's plain code).

- the scalp texture [T, T, 64 + 65] is read bilinearly at each root's uv;
- the strand decoder maps the 64 geometry channels and the Fourier features
  of the arc position to L - 1 local segment vectors (divided by 100), which
  the root's tangent frame places in the world;
- the colour decoder maps the 64 appearance channels after the label to SH
  coefficients and a log orientation confidence;
- each segment is a Gaussian at its midpoint, rotated by the parallel
  transport of +x onto it, with scales [|segment| / 2, r, r];
- the UNet: Fourier features of log(sigma) / 4 -> a 256-wide mapping, res
  blocks (GroupNorm, SiLU, 3x3 conv, scale and shift from the mapping, SiLU,
  3x3 conv, 1x1 skip where the width changes, / sqrt 2) at channels
  (128, 256, 512), 2x2 average pooling down, nearest upsampling and skip
  concatenation up, a 3x3 conv out.

``param_specs`` lists every weight with its shape and its initialiser (the
flax defaults the port draws: lecun-normal kernels truncated at two standard
deviations, zero biases, unit GroupNorm scales; normal Fourier weights, a
zero last UNet conv, a 1e-2 normal last decoder layer, a 1e-2 normal
texture).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import geometry as geo
from reference import precision as prec
from reference.render import Fields


def _dense(name, n_in, n_out, init="lecun"):
    return [(f"{name}.weight", (n_out, n_in), init), (f"{name}.bias", (n_out,), "zeros")]


def _conv(name, c_in, c_out, k, init="lecun"):
    return [(f"{name}.weight", (c_out, c_in, k, k), init), (f"{name}.bias", (c_out,), "zeros")]


def decoder_specs(prefix: str, length: int, hidden: int = 256, freqs: int = 6,
                  latent: int = 64):
    return (_dense(f"{prefix}.latent_in", latent, hidden)
            + _dense(f"{prefix}.pos_in", 2 * freqs + 1, hidden)
            + _dense(f"{prefix}.hidden1", hidden, hidden)
            + _dense(f"{prefix}.hidden2", hidden, hidden)
            + _dense(f"{prefix}.out", hidden, 3, init="normal:0.01"))


def colour_specs(prefix: str, sh_degree: int, hidden: int = 128, latent: int = 64):
    return (_dense(f"{prefix}.inp", latent, hidden) + _dense(f"{prefix}.hidden", hidden, hidden)
            + _dense(f"{prefix}.out", hidden, 3 * (sh_degree + 1) ** 2 + 1))


def unet_blocks(unet: dict):
    """(name, c_in, c_out) of every res block, down then up."""
    depths, chans, c = unet["depths"], unet["channels"], unet["input_channels"]
    down, up = [], []
    for depth, ch in zip(depths, chans):
        for _ in range(depth):
            down.append((f"down.{len(down)}", c, ch))
            c = ch
    for level in reversed(range(len(depths))):
        ch = chans[level]
        if level < len(depths) - 1:
            c += chans[level]
        for _ in range(depths[level]):
            up.append((f"up.{len(up)}", c, ch))
            c = ch
    return down, up, c


def unet_specs(prefix: str, unet: dict):
    m = unet["mapping_out"]
    out = [(f"{prefix}.fourier.w", (8,), "normal:1.0")]
    out += _dense(f"{prefix}.map_in", 16, m) + _dense(f"{prefix}.map_out", m, m)
    down, up, c_last = unet_blocks(unet)
    for name, ci, co in down + up:
        p = f"{prefix}.{name}"
        out += [(f"{p}.norm.weight", (ci,), "ones"), (f"{p}.norm.bias", (ci,), "zeros")]
        out += _dense(f"{p}.cond", m, 2 * co) + _conv(f"{p}.conv1", ci, co, 3)
        out += _conv(f"{p}.conv2", co, co, 3)
        if ci != co:
            out += _conv(f"{p}.skip", ci, co, 1)
    out += _conv(f"{prefix}.out", c_last, unet["input_channels"], 3, init="zeros")
    return out


def param_specs(cfg: dict):
    """Every stage-2 weight: (name, shape, initialiser), in the port's order."""
    t = cfg["texture_size"]
    specs = [("texture", (t, t, cfg["geometry_descriptor_size"]
                          + cfg["appearance_descriptor_size"]), "normal:0.01")]
    specs += decoder_specs("decoder", cfg["strand_length"])
    specs += colour_specs("color_decoder", cfg["sh_degree"])
    specs += unet_specs("denoiser.net", cfg["unet"])
    return specs


# ---------------------------------------------------------------- strands --

def sample_texture(texture, uvs):
    t = texture.shape[0]
    xy = uvs * (t - 1)
    x0 = torch.clamp(torch.floor(xy).to(torch.int64), 0, t - 2)
    frac = torch.clamp(xy - x0, 0.0, 1.0)
    fx, fy = frac[:, 0:1], frac[:, 1:2]
    top = texture[x0[:, 1], x0[:, 0]] * (1 - fx) + texture[x0[:, 1], x0[:, 0] + 1] * fx
    bot = texture[x0[:, 1] + 1, x0[:, 0]] * (1 - fx) + texture[x0[:, 1] + 1, x0[:, 0] + 1] * fx
    return top * (1 - fy) + bot * fy


def decode_segments(w: dict, z, length: int, freqs: int = 6):
    dev = z.device
    t = torch.linspace(0.0, 1.0, length - 1, device=dev)
    f = 2.0 ** torch.arange(freqs, dtype=torch.float32, device=dev)
    ang = t[:, None] * f[None, :] * math.pi
    pos = torch.cat([torch.sin(ang), torch.cos(ang), t[:, None]], -1)
    lin = lambda x, n: prec.linear(x, w[f"decoder.{n}.weight"], w[f"decoder.{n}.bias"])
    h = F.silu(lin(z, "latent_in"))
    h = h[:, None, :] + lin(pos, "pos_in")
    h = F.silu(lin(h, "hidden1"))
    h = F.silu(lin(h, "hidden2"))
    return lin(h, "out")


def decode_colour(w: dict, z):
    lin = lambda x, n: prec.linear(x, w[f"color_decoder.{n}.weight"], w[f"color_decoder.{n}.bias"])
    return lin(F.relu(lin(F.relu(lin(z, "inp")), "hidden")), "out")


def strands(w: dict, pool: dict, roots, cfg: dict):
    """-> (world points [N, L, 3], appearance code [N, 64])."""
    origins, uvs, l2w = pool["origins"][roots], pool["uvs"][roots], pool["local2world"][roots]
    z = sample_texture(w["texture"], uvs)
    g = cfg["geometry_descriptor_size"]
    segs = decode_segments(w, z[:, :g], cfg["strand_length"]) / cfg["scale_decoder"]
    local = torch.cat([torch.zeros_like(segs[:, :1]), torch.cumsum(segs, dim=1)], dim=1)
    world = origins[:, None, :] + prec.einsum("nij,nlj->nli", l2w, local)
    return world, z[:, g + 1:]


def hair_fields(w: dict, pool: dict, roots, cfg: dict, radius: float):
    """The hair's segment Gaussians as renderer fields."""
    pts, z_app = strands(w, pool, roots, cfg)
    n, s = pts.shape[0], pts.shape[1] - 1
    mid = (0.5 * (pts[:, 1:] + pts[:, :-1])).reshape(-1, 3)
    seg = (pts[:, 1:] - pts[:, :-1]).reshape(-1, 3)
    x_axis = torch.zeros_like(seg)
    x_axis[:, 0] = 1.0
    rot = geo.build_rotation(geo.parallel_transport(x_axis, seg))
    half = 0.5 * torch.sqrt(torch.clamp(torch.sum(seg * seg, -1, keepdim=True), min=1e-24))
    r = torch.full_like(half, radius)
    k = (cfg["sh_degree"] + 1) ** 2
    out = decode_colour(w, z_app)
    per_seg = lambda x: x[:, None].expand(n, s, *x.shape[1:]).reshape(n * s, *x.shape[1:])
    features = torch.cat([per_seg(out[:, :3].reshape(n, 1, 3)),
                          per_seg(out[:, 3:3 * k].reshape(n, k - 1, 3))], dim=1)
    conf = torch.exp(torch.clamp(per_seg(out[:, 3 * k:]), -30.0, 30.0))
    ones = torch.ones((n * s, 1), device=pts.device)
    return Fields(xyz=mid, features=features, scaling=torch.cat([half, r, r], -1), rotation=rot,
                  opacity=ones, label=ones, orient_conf=conf,
                  valid=torch.ones(n * s, dtype=torch.bool, device=pts.device),
                  viewspace=torch.zeros((n * s, 3), device=pts.device),
                  use_direction=torch.ones(n * s, device=pts.device))


# ------------------------------------------------------------------- UNet --

def _groups(c: int) -> int:
    return 32 if c % 32 == 0 else 1


def unet(w: dict, prefix: str, x, sigma, cfg: dict):
    """x [N, H, W, C] channels-last, sigma [N] -> [N, H, W, C]."""
    depths = cfg["depths"]
    get = lambda n: w[f"{prefix}.{n}"]
    lin = lambda v, n: prec.linear(v, get(f"{n}.weight"), get(f"{n}.bias"))
    conv = lambda v, n, pad: prec.conv2d(v, get(f"{n}.weight"), get(f"{n}.bias"), padding=pad)
    ang = 2 * math.pi * (torch.log(sigma) / 4.0)[:, None] * get("fourier.w")
    mapping = lin(F.silu(lin(torch.cat([torch.cos(ang), torch.sin(ang)], -1), "map_in")),
                  "map_out")

    def block(h, name, c_in, c_out):
        g = F.silu(F.group_norm(h, _groups(c_in), get(f"{name}.norm.weight"),
                                get(f"{name}.norm.bias"), eps=1e-6))
        ss = lin(F.silu(mapping), f"{name}.cond")
        g = conv(g, f"{name}.conv1", 1)
        scale, shift = ss[:, :, None, None].chunk(2, dim=1)
        g = conv(F.silu(g * (1 + scale) + shift), f"{name}.conv2", 1)
        skip = h if c_in == c_out else conv(h, f"{name}.skip", 0)
        return (g + skip) / math.sqrt(2.0)

    down, up, _ = unet_blocks(cfg)
    h = x.permute(0, 3, 1, 2).contiguous()
    blocks, skips = iter(down), []
    for level, depth in enumerate(depths):
        if level > 0:
            h = F.avg_pool2d(h, 2)
        for _ in range(depth):
            h = block(h, *next(blocks))
        skips.append(h)
    blocks = iter(up)
    for level in reversed(range(len(depths))):
        if level < len(depths) - 1:
            h = F.interpolate(h, size=skips[level].shape[-2:], mode="nearest-exact")
            h = torch.cat([h, skips[level]], dim=1)
        for _ in range(depths[level]):
            h = block(h, *next(blocks))
    return conv(h, "out", 1).permute(0, 2, 3, 1)


def denoiser_loss(w: dict, prefix: str, x0, noise, sigma, cfg: dict):
    """The EDM-weighted denoising loss (sigma_data 0.5), unmasked."""
    sd = cfg["sigma_data"]
    s = sigma[:, None, None, None]
    weight = (s ** 2 + sd ** 2) / (s * sd) ** 2
    noisy = x0 + noise * s
    c_skip = sd ** 2 / (s ** 2 + sd ** 2)
    c_out = s * sd / torch.sqrt(s ** 2 + sd ** 2)
    c_in = 1.0 / torch.sqrt(s ** 2 + sd ** 2)
    den = c_skip * noisy + c_out * unet(w, prefix, c_in * noisy, sigma, cfg)
    return torch.mean((den - x0) ** 2 * weight)
