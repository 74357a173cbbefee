"""The reference's 10-channel Gaussian compositing (3DGS's forward.cu and
backward.cu semantics, written as dense tensor algebra).

Binning is the original's: each Gaussian in front of the near plane
(depth > 0.2) with a non-empty 3-sigma tile rect is copied to every tile of
the rect, and each tile's copies are ordered by depth (ties by Gaussian
index).  A tile's pixels then see all of its Gaussians at once, as a
[pixels, instances] matrix:

- alpha = min(0.99, opacity * exp(power)); a pair is a candidate when
  power <= 0 and alpha >= 1/255;
- T before a pair is the product of (1 - alpha) over the pixel's earlier
  candidates (a cumulative product);
- a pixel stops at the first candidate after which T would fall below 1e-4:
  that candidate and every later pair are not blended;
- colour = sum of alpha T colour over the blended pairs, and the image is
  colour + T_final * background.

Autograd takes the gradient, with the original's one departure: the 0.99
clamp is transparent to it.  Each block of a tile's pixels is one
checkpointed segment, so only its inputs are kept between the forward and
the backward.  No kernel, no chunked layout, no culling beyond the 3-sigma
rect: the pairs that are not candidates are computed and masked out.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from reference import precision as prec

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
NEAR_Z = 0.2
CHANNELS = 10
BLOCK_ELEMS = 1 << 24          # pixels x instances of one segment


@dataclasses.dataclass
class Binning:
    """The depth-ordered instances of every tile."""
    gid: torch.Tensor          # [N] Gaussian of each instance, tile-major, by depth
    starts: list               # [T] first instance of each tile
    counts: list               # [T] instances of each tile
    radius: torch.Tensor       # [P] 3-sigma radius in pixels (0 when culled)
    grid: tuple                # (gx, gy)


def pixel_means(ndc: torch.Tensor, width: int, height: int) -> torch.Tensor:
    size = torch.tensor([width, height], dtype=ndc.dtype, device=ndc.device)
    return ((ndc[:, :2] + 1.0) * size - 1.0) * 0.5


def bin_gaussians(mean_pix, cov2d, depth, valid, width: int, height: int,
                  tile: int = 32) -> Binning:
    """3-sigma radius, tile rect and the depth-sorted per-tile instance lists
    (forward.cu:155-282, rasterizer_impl.cu:70-138)."""
    with torch.no_grad():
        gx, gy = -(-width // tile), -(-height // tile)
        det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
        mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
        root = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        lam = torch.maximum(mid + root, mid - root)
        radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
        px, py = mean_pix[:, 0], mean_pix[:, 1]
        x0 = torch.clamp(((px - radius) / tile).to(torch.int32), 0, gx).long()
        y0 = torch.clamp(((py - radius) / tile).to(torch.int32), 0, gy).long()
        x1 = torch.clamp(((px + radius + tile - 1) / tile).to(torch.int32), 0, gx).long()
        y1 = torch.clamp(((py + radius + tile - 1) / tile).to(torch.int32), 0, gy).long()
        area = (x1 - x0) * (y1 - y0)
        ok = valid & (det != 0) & (depth > NEAR_Z) & (area > 0)
        radius = torch.where(ok, radius, torch.zeros_like(radius))
        n_tiles = torch.where(ok, area, torch.zeros_like(area))
        total = int(n_tiles.sum())
        gid = torch.repeat_interleave(torch.arange(len(px), device=px.device), n_tiles,
                                      output_size=total)
        within = torch.arange(total, device=px.device) - (torch.cumsum(n_tiles, 0) - n_tiles)[gid]
        w = torch.clamp(x1 - x0, min=1)[gid]
        tile_id = (y0[gid] + within // w) * gx + x0[gid] + within % w
        dbits = depth.detach().to(torch.float32).contiguous().view(torch.int32).long()[gid]
        order = torch.sort((tile_id << 32) | dbits, stable=True).indices
        counts = torch.bincount(tile_id, minlength=gx * gy)
        starts = torch.cumsum(counts, 0) - counts
        return Binning(gid[order], starts.tolist(), counts.tolist(), radius, (gx, gy))


def _blend(px, py, mx, my, ca, cb, cc, op, col):
    """One block of a tile: pixels (px, py) [Q] against its instances [n] in
    depth order -> (colour [Q, 10], T_final [Q], blended pairs [Q, n])."""
    dx = mx[None, :] - px[:, None]
    dy = my[None, :] - py[:, None]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    raw = op * torch.exp(power)
    alpha = raw + (torch.clamp(raw, max=ALPHA_CLAMP) - raw).detach()
    cand = (power <= 0.0) & (alpha.detach() >= ALPHA_MIN)
    one_minus = 1.0 - torch.where(cand, alpha, torch.zeros_like(alpha))
    t_after = torch.cumprod(one_minus, dim=1)
    blended = cand & (t_after.detach() >= T_EPS)
    t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], dim=1)
    w = torch.where(blended, (1.0 - one_minus) * t_before, torch.zeros_like(t_before))
    colour = prec.matmul(w, col)
    t_final = torch.prod(torch.where(blended, one_minus, torch.ones_like(one_minus)), dim=1)
    return colour, t_final, blended


def _segment(px, py, mx, my, ca, cb, cc, op, col):
    colour, t_final, _ = _blend(px, py, mx, my, ca, cb, cc, op, col)
    return torch.cat([colour, t_final[:, None]], dim=1)


def _blocks(binning: Binning, tile: int):
    """(tile, first row, rows, first instance, instances) of every segment."""
    for t, (s, n) in enumerate(zip(binning.starts, binning.counts)):
        rows = tile if n == 0 else max(1, min(tile, BLOCK_ELEMS // (n * tile)))
        for r0 in range(0, tile, rows):
            yield t, r0, min(rows, tile - r0), s, n


def _pixels(t, r0, rows, gx, tile, device):
    i = torch.arange(rows * tile, device=device)
    px = (t % gx) * tile + i % tile
    py = (t // gx) * tile + r0 + i // tile
    return px.to(torch.float32), py.to(torch.float32)


def composite(mean_pix, conic, opacity, colours, binning: Binning, bg, width: int,
              height: int, tile: int = 32):
    """-> (image [10, H, W] with the background blended in, T_final [H, W]),
    differentiable in mean_pix, conic, opacity [P] and colours [P, 10]."""
    gx, gy = binning.grid
    dev = mean_pix.device
    out = []
    for t, r0, rows, s, n in _blocks(binning, tile):
        px, py = _pixels(t, r0, rows, gx, tile, dev)
        if n == 0:
            out.append(torch.cat([torch.zeros((len(px), CHANNELS), device=dev),
                                  torch.ones((len(px), 1), device=dev)], 1))
            continue
        g = binning.gid[s:s + n]
        args = (px, py, mean_pix[g, 0], mean_pix[g, 1], conic[g, 0], conic[g, 1],
                conic[g, 2], opacity[g], colours[g])
        if torch.is_grad_enabled():
            out.append(checkpoint(_segment, *args, use_reentrant=False))
        else:
            out.append(_segment(*args))
    buf = torch.cat(out, 0).reshape(gy, gx, tile, tile, CHANNELS + 1)
    buf = buf.permute(4, 0, 2, 1, 3).reshape(CHANNELS + 1, gy * tile, gx * tile)
    buf = buf[:, :height, :width]
    t_final = buf[CHANNELS]
    return buf[:CHANNELS] + t_final[None] * bg[:CHANNELS, None, None], t_final


@torch.no_grad()
def count_pairs(mean_pix, conic, opacity, colours, binning: Binning, tile: int = 32):
    """-> (blended pairs, Gaussians with a blended pair): the work the
    compositing needs on these inputs, whatever any kernel visits."""
    gx, _ = binning.grid
    dev = mean_pix.device
    pairs = 0
    used = torch.zeros(mean_pix.shape[0], dtype=torch.bool, device=dev)
    for t, r0, rows, s, n in _blocks(binning, tile):
        if n == 0:
            continue
        px, py = _pixels(t, r0, rows, gx, tile, dev)
        g = binning.gid[s:s + n]
        _, _, blended = _blend(px, py, mean_pix[g, 0], mean_pix[g, 1], conic[g, 0],
                               conic[g, 1], conic[g, 2], opacity[g], colours[g])
        pairs += int(blended.sum())
        used[g[blended.any(0)]] = True
    return pairs, int(used.sum())
