"""Plain PyTorch versions of the two compositing kernels (port of
``gaussianhaircut_tpu/ops/rasterize/jnp_core.py``, in the linear domain).

Same inputs and outputs as the CUDA kernels in ``cuda_core.py``: the
chunk-aligned ``payload`` [TC, 24, CH] with per-tile ``chunk_start`` /
``nchunks``, the tile buffer [T, PIX, 16] (channels 0-9 colour, 14 the done
latch, 15 the final transmittance) and the per-instance gradient rows
``dpay`` [TC, 16, CH] = (d mean2D x, y in pixels, d conic a, b, c,
d opacity, d colour 0-9).

Both take the k-th chunk of every tile at once and walk its instances in
order, vectorised over tiles and pixels, with the kernels' arithmetic in the
kernels' order: the transmittance is a running product, so every pixel
stops (T would drop below 1e-4) at the same instance as in the kernel.  A
chunk is skipped once every pixel of its tile has stopped, as the kernels
do.  They are what the CPU runs and what the kernels are held against on
the card.

``warp_masks_plain`` mirrors the kernels' exact per-warp cull
(``csrc/raster_common.cuh: warp_mask``): the plain versions evaluate every
pair and need no cull, but the card's masks are held against it and the
CPU tests show it conservative.
"""
from __future__ import annotations

import numpy as np
import torch

from gaussianhaircut_torch.ops.rasterize import common as C

# the warps' pixel footprints and the cull's constants (raster_common.cuh)
FOOT_W, FOOT_H = 8, 4
CULL_PAD = 1.0
CULL_SLACK = 1e-3
CULL_MAX_POS = 2.0 ** 20
CULL_MAX_VAL = 2.0 ** 40
CULL_MAX_COND = 2.0 ** 20
CULL_U = 2.0 ** -24
ALPHA_MIN_F32 = float(np.float32(1.0) / np.float32(255.0))   # the kernels' 1.0f / 255.0f


class _Walk:
    """Per-pixel front-to-back state of the tiles being walked."""

    def __init__(self, num_tiles: int, pix: int, device):
        self.t = torch.ones((num_tiles, pix), device=device)
        self.done = torch.zeros((num_tiles, pix), dtype=torch.bool, device=device)

    def live_chunk_tiles(self, nchunks: torch.Tensor, k: int) -> torch.Tensor:
        """Tiles that own a k-th chunk and still have a live pixel (a set
        that only shrinks as k grows)."""
        return torch.nonzero((nchunks > k) & ~self.done.all(dim=1))[:, 0]


def _instance(pay, j, px, py, t, done):
    """Instance j of each tile's chunk against every pixel (forward.cu:
    351-388): returns the blend terms and the masks.  pay [T', 24, CH];
    px, py, t [T', PIX]; done [T', PIX] bool."""
    g = pay[:, :8, j, None]                               # [T', 8, 1]
    dx = g[:, C.F_GX] - px
    dy = g[:, C.F_GY] - py
    a, b, c = g[:, C.F_CA], g[:, C.F_CB], g[:, C.F_CC]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    expp = torch.exp(power)
    raw = g[:, C.F_OP] * expp
    alpha = torch.clamp(raw, max=C.ALPHA_CLAMP)
    visited = (g[:, C.F_VALID] > 0.5) & ~done
    cand = visited & (power <= 0.0) & (alpha >= C.ALPHA_MIN)
    test = t * (1.0 - alpha)
    fail = cand & (test < C.T_EPS)
    contrib = cand & ~fail
    w = torch.where(contrib, alpha * t, torch.zeros_like(alpha))
    return dict(dx=dx, dy=dy, a=a, b=b, c=c, expp=expp, raw=raw, alpha=alpha,
                test=test, fail=fail, contrib=contrib, visited=visited, w=w)


def raster_fwd_plain(payload: torch.Tensor, chunk_start: torch.Tensor,
                     nchunks: torch.Tensor, width: int, height: int,
                     cfg: C.RasterConfig, stats: dict | None = None,
                     masks: torch.Tensor | None = None, row0: int = 0) -> torch.Tensor:
    """Composite each tile's depth-sorted instances front to back ->
    tile_buf [T, PIX, 16].  With ``stats``, counts the (pixel, instance)
    pairs this input needs: ``visited`` (evaluated before the pixel stops)
    and ``contrib`` (blended); given the per-warp cull ``masks`` [TC, CH]
    (``warp_masks_plain``), also ``kept``: the visited pairs whose warp's
    bit is set, the pairs the kernels must evaluate.  The grid holds a
    batch of images of ``height`` rows, or covers one image's rows from
    ``row0`` on (``common.pixel_coords``)."""
    num_tiles = chunk_start.shape[0]
    dev = payload.device
    px, py = C.pixel_coords(num_tiles, width, cfg, dev, row0, cfg.grid(width, height)[1])
    acc = torch.zeros((num_tiles, cfg.tile_pix, C.NUM_CHANNELS), device=dev)
    walk = _Walk(num_tiles, cfg.tile_pix, dev)
    cs, nc = chunk_start.long(), nchunks.long()
    counts = {"visited": 0, "contrib": 0} | ({"kept": 0} if masks is not None else {})
    warp = warp_of_pixel(cfg).to(dev)
    for k in range(int(nc.max()) if num_tiles else 0):
        tiles = walk.live_chunk_tiles(nc, k)
        if not len(tiles):
            break                       # no tile is live at k, so none at k + 1
        pay = payload[cs[tiles] + k]
        mk = masks[cs[tiles] + k] if masks is not None else None
        pxt, pyt, t, done = px[tiles], py[tiles], walk.t[tiles], walk.done[tiles]
        a = acc[tiles]
        for j in range(pay.shape[2]):
            q = _instance(pay, j, pxt, pyt, t, done)
            a = a + q["w"][..., None] * pay[:, None, 8:8 + C.NUM_CHANNELS, j]
            t = torch.where(q["contrib"], q["test"], t)
            done = done | q["fail"]
            if stats is not None:
                counts["visited"] += q["visited"].sum()
                counts["contrib"] += q["contrib"].sum()
                if mk is not None:
                    bit = (mk[:, j, None] >> warp) & 1
                    counts["kept"] += (q["visited"] & (bit > 0)).sum()
        acc[tiles], walk.t[tiles], walk.done[tiles] = a, t, done
    if stats is not None:
        for key, v in counts.items():
            stats[key] = stats.get(key, 0) + int(v)
    zeros = torch.zeros((num_tiles, cfg.tile_pix, C.CH_DONE - C.NUM_CHANNELS),
                        device=dev)
    return torch.cat([acc, zeros, walk.done.to(torch.float32)[..., None],
                      walk.t[..., None]], dim=-1)


def raster_probe_plain(payload: torch.Tensor, chunk_start: torch.Tensor,
                       nchunks: torch.Tensor, cfg: C.RasterConfig) -> torch.Tensor:
    """The fixed-cost probe's result -> tile_buf [T, PIX, 16]: for each tile,
    the sum over its chunks of payload row 0 summed over the lanes,
    broadcast (tools/tpu_profile_r4.py:502-529).  Tiles without chunks
    stay 0.  Summed in float64, so it is the reference the kernel's float32
    sums are held against."""
    num_tiles = chunk_start.shape[0]
    nc = nchunks.long()
    tile_of = torch.repeat_interleave(torch.arange(num_tiles, device=nc.device), nc)
    first = torch.repeat_interleave(chunk_start.long() - (torch.cumsum(nc, 0) - nc), nc)
    chunks = first + torch.arange(tile_of.shape[0], device=nc.device)
    row_sum = payload[chunks, C.F_GX].to(torch.float64).sum(dim=1)
    per_tile = torch.zeros(num_tiles, dtype=torch.float64, device=payload.device)
    per_tile.index_add_(0, tile_of, row_sum)
    return per_tile.to(torch.float32)[:, None, None].expand(
        num_tiles, cfg.tile_pix, C.PAD_CHANNELS).contiguous()


def raster_bwd_plain(payload: torch.Tensor, chunk_start: torch.Tensor,
                     nchunks: torch.Tensor, tile_buf: torch.Tensor,
                     gbuf: torch.Tensor, width: int, height: int,
                     cfg: C.RasterConfig, row0: int = 0) -> torch.Tensor:
    """Per-instance gradients summed over each tile's pixels -> dpay
    [TC, 16, CH] (zero for chunks not reached).

    The back-to-front suffix of the CUDA reference's backward is
    ``total - prefix``, where total = sum over the 16 channels of g * out per
    pixel, so the background and final-T cotangent (channel 15) reach
    d alpha through it.  The gradient ignores the 0.99 clamp
    (backward.cu:502-558)."""
    num_tiles = chunk_start.shape[0]
    dev = payload.device
    px, py = C.pixel_coords(num_tiles, width, cfg, dev, row0, cfg.grid(width, height)[1])
    total = torch.sum(gbuf * tile_buf, dim=-1)                    # [T, PIX]
    prefix = torch.zeros((num_tiles, cfg.tile_pix), device=dev)
    walk = _Walk(num_tiles, cfg.tile_pix, dev)
    dpay = torch.zeros((payload.shape[0], C.GRAD_ROWS, payload.shape[2]),
                       device=dev)
    cs, nc = chunk_start.long(), nchunks.long()
    for k in range(int(nc.max()) if num_tiles else 0):
        tiles = walk.live_chunk_tiles(nc, k)
        if not len(tiles):
            break
        chunks = cs[tiles] + k
        pay = payload[chunks]
        pxt, pyt, t, done = px[tiles], py[tiles], walk.t[tiles], walk.done[tiles]
        g = gbuf[tiles, :, :C.NUM_CHANNELS]                       # [T', PIX, 10]
        tot, pre = total[tiles], prefix[tiles]
        rows = []
        for j in range(pay.shape[2]):
            q = _instance(pay, j, pxt, pyt, t, done)
            u = torch.sum(g * pay[:, None, 8:8 + C.NUM_CHANNELS, j], dim=-1)
            pre = pre + u * q["w"]
            suffix = tot - pre
            dalpha = torch.where(q["contrib"], u * t - suffix / (1.0 - q["alpha"]),
                                 torch.zeros_like(u))
            m = dalpha * q["raw"]                                 # dL/d power
            dx, dy = q["dx"], q["dy"]
            terms = torch.stack([
                -(q["a"] * dx + q["b"] * dy) * m,                 # d mean x
                -(q["c"] * dy + q["b"] * dx) * m,                 # d mean y
                -0.5 * m * dx * dx,                               # d conic a
                -m * dx * dy,                                     # d conic b
                -0.5 * m * dy * dy,                               # d conic c
                dalpha * q["expp"],                               # d opacity
            ], dim=-1)
            dcol = g * q["w"][..., None]                          # d colour
            rows.append(torch.cat([terms, dcol], dim=-1).sum(dim=1))
            t = torch.where(q["contrib"], q["test"], t)
            done = done | q["fail"]
        dpay[chunks] = torch.stack(rows, dim=-1)
        prefix[tiles], walk.t[tiles], walk.done[tiles] = pre, t, done
    return dpay


def warp_of_pixel(cfg: C.RasterConfig) -> torch.Tensor:
    """[PIX] int64: the warp whose 8x4 block holds each tile-buffer pixel."""
    i = torch.arange(cfg.tile_pix)
    return (i // cfg.tile_w) // FOOT_H * (cfg.tile_w // FOOT_W) + (i % cfg.tile_w) // FOOT_W


def warp_masks_plain(payload: torch.Tensor, chunk_start: torch.Tensor,
                     nchunks: torch.Tensor, width: int,
                     cfg: C.RasterConfig, row0: int = 0,
                     grid_y: int | None = None) -> torch.Tensor:
    """The kernels' per-warp cull -> masks [TC, CH] int64 (bit w set: warp
    w walks the instance; 0 for chunks in no tile's range).  The same
    float64 operations in the same order as ``warp_mask`` in
    ``csrc/raster_common.cuh``, which states why the box holds every pair
    the kernels' float test accepts.  ``grid_y``: the tile rows of one
    image of a batch (None: the layout is one image)."""
    tc, _, ch = payload.shape
    dev = payload.device
    nwx, nwy = cfg.tile_w // FOOT_W, cfg.tile_h // FOOT_H
    all_bits = (1 << (nwx * nwy)) - 1
    num_tiles = chunk_start.shape[0]
    gx_grid, _ = cfg.grid(width, 1)
    gy_grid = grid_y or -(-num_tiles // gx_grid)
    nc = nchunks.long()
    tile_of = torch.repeat_interleave(torch.arange(num_tiles, device=dev), nc)
    first = torch.repeat_interleave(chunk_start.long() - (torch.cumsum(nc, 0) - nc), nc)
    chunks = first + torch.arange(tile_of.shape[0], device=dev)
    geo = payload[chunks, :6]                                   # [n, 6, CH] f32
    x0 = ((tile_of % gx_grid) * cfg.tile_w)[:, None]
    y0 = (row0 + ((tile_of // gx_grid) % gy_grid) * cfg.tile_h)[:, None]
    X, Y, A, B, Cc, O = (geo[:, r].double() for r in range(6))
    tame = ((X.abs() < CULL_MAX_POS) & (Y.abs() < CULL_MAX_POS)
            & (A.abs() < CULL_MAX_VAL) & (B.abs() < CULL_MAX_VAL)
            & (Cc.abs() < CULL_MAX_VAL) & (O.abs() < CULL_MAX_VAL)
            & (x0 + cfg.tile_w <= CULL_MAX_POS) & (y0 + cfg.tile_h <= CULL_MAX_POS))
    faint = geo[:, C.F_OP] < ALPHA_MIN_F32
    det = A * Cc - B * B
    tr = A + Cc
    cond = tr * tr / det
    cull_ok = (A > 0.0) & (det > 0.0) & ~(cond > CULL_MAX_COND)
    lim = torch.log(O / ALPHA_MIN_F32) + CULL_SLACK
    qmax = 2.0 * lim / (1.0 - (8.0 * CULL_U) * cond - 4.0 * CULL_U)
    ex = torch.sqrt(qmax * Cc / det) + CULL_PAD
    ey = torch.sqrt(qmax * A / det) + CULL_PAD
    bx0, bx1, by0, by1 = X - ex, X + ex, Y - ey, Y + ey
    cols = torch.zeros_like(chunks[:, None].expand(-1, ch))
    for i in range(nwx):
        lo = (x0 + i * FOOT_W).double()
        cols |= ((lo <= bx1) & (lo + (FOOT_W - 1) >= bx0)).long() << i
    box = torch.zeros_like(cols)
    for i in range(nwy):
        lo = (y0 + i * FOOT_H).double()
        box |= torch.where((lo <= by1) & (lo + (FOOT_H - 1) >= by0), cols << (i * nwx), 0)
    mask = torch.where(cull_ok, box, all_bits)
    mask = torch.where(faint, 0, mask)
    mask = torch.where(tame, mask, all_bits)
    out = torch.zeros((tc, ch), dtype=torch.int64, device=dev)
    out[chunks] = mask
    return out
