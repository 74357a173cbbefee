"""Shared rasterizer machinery: config, per-Gaussian preprocess, tile
binning, the chunk-aligned instance layout and image assembly (port of
``gaussianhaircut_tpu/ops/rasterize/common.py``).

Reference semantics (behaviour, not code): preprocess = forward.cu:155-282;
binning = rasterizer_impl.cu:70-138 (duplicateWithKeys, a radix sort on
``tile << 32 | depth-bits``, identifyTileRanges).

The instance buffer is sized every call from ``num_rendered`` with one
device-to-host sync, as the CUDA reference does (rasterizer_impl.cu:281-289);
the JAX package's static capacity and overflow handling are not needed.

The layout is the JAX package's *chunk-aligned* one: every tile's instance
list starts at a chunk boundary and is padded to a whole number of chunks
(>= 1).  Chunks past the last used one (the layout is sized from an upper
bound, so no second sync is needed) are marked ``chunk_in_tile = -1`` and
belong to no tile's ``[chunk_start, chunk_start + nchunks)`` range.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# Compositing constants (forward.cu:361-377).
ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
NEAR_Z = 0.2

NUM_CHANNELS = 10          # rgb(3) + label/fg(2) + dir2d(3) + orient_conf(1) + depth(1)
PAD_CHANNELS = 16
CH_DONE = 14               # tile-buffer channel holding the early-stop latch
CH_TRANS = 15              # tile-buffer channel holding the final transmittance
PAYLOAD_ROWS = 24          # rows 0..7 geometry, rows 8..23 transposed colours
GRAD_ROWS = 6 + NUM_CHANNELS

# geometry rows of a payload chunk
F_GX, F_GY, F_CA, F_CB, F_CC, F_OP, F_VALID, F_PAD = range(8)


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    tile_w: int = 32
    tile_h: int = 32
    chunk: int = 256             # instances per chunk

    @property
    def tile_pix(self) -> int:
        return self.tile_w * self.tile_h

    def grid(self, width: int, height: int) -> tuple[int, int]:
        return -(-width // self.tile_w), -(-height // self.tile_h)


class Binned(NamedTuple):
    """Chunk-aligned instance buffers consumed by the compositing kernels."""
    payload: torch.Tensor        # [TC, 24, CH] f32
    tile_of_chunk: torch.Tensor  # [TC] int32
    chunk_in_tile: torch.Tensor  # [TC] int32 (0 = first chunk, -1 = unused)
    chunk_start: torch.Tensor    # [T] int32 first chunk of each tile
    nchunks: torch.Tensor        # [T] int32 chunks of each tile (>= 1)
    gid: torch.Tensor            # [TC, CH] int64 source Gaussian (P if empty)
    slot_of_instance: torch.Tensor  # [N] int64 flat slot of each instance,
                                 # in expansion (gid-ascending) order
    gauss_offset: torch.Tensor   # [P] int64 exclusive prefix of tiles_touched
    gauss_count: torch.Tensor    # [P] int64 tiles_touched
    num_rendered: int            # N, the instance count (over every camera)
    num_tiles: int               # B * tiles per image
    num_rendered_bound: int      # B * the largest camera's count (N at B = 1)


class Preprocessed(NamedTuple):
    mean_pix: torch.Tensor       # [P, 2]
    radius: torch.Tensor         # [P] float (0 for culled)
    tiles_touched: torch.Tensor  # [P] int64
    rect: tuple                  # (min_x, min_y, max_x, max_y) int64 [P]
    valid: torch.Tensor          # [P] bool after all culling


def cov2d_from_conic(conic: torch.Tensor):
    """Packed 2D covariance recovered from a conic (forward.cu:240-248).
    Returns (cov2d [P, 3], det_ok [P])."""
    det_inv = conic[:, 0] * conic[:, 2] - conic[:, 1] ** 2
    det_ok = det_inv != 0.0
    det = 1.0 / torch.where(det_ok, det_inv, torch.ones_like(det_inv))
    cov = torch.stack([conic[:, 2], -conic[:, 1], conic[:, 0]], dim=-1) * det[:, None]
    return cov, det_ok


def preprocess(mean_pix: torch.Tensor, conic: torch.Tensor, depth: torch.Tensor,
               valid_in: torch.Tensor, width: int, height: int,
               cfg: RasterConfig, opacity: torch.Tensor | None = None,
               row0: int = 0) -> Preprocessed:
    """Per-Gaussian culling, radius and tile rect (forward.cu:155-282).

    With ``row0`` (a whole number of tile rows) the grid covers the rows
    [row0, row0 + height) of a taller image and ``mean_pix`` is in the
    image's pixels: the rect is the image grid's, shifted by row0's tile
    rows and clamped to the window, so each of the window's tiles gets the
    image's instances for that tile.

    With ``opacity``, the binned rect shrinks to the exact-skip radius
    sigma*sqrt(2 ln(255 op)), outside which alpha < 1/255 everywhere (both
    kernels skip such pixels, so dropping the instances is exact).  The
    reported ``radius`` keeps the reference's 3-sigma value."""
    gx_grid, gy_grid = cfg.grid(width, height)
    if row0 % cfg.tile_h:
        raise ValueError(f"row0 {row0} is not a whole number of {cfg.tile_h}-row tiles")
    t0 = row0 // cfg.tile_h
    cov2d, det_ok = cov2d_from_conic(conic)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    sqrt_d = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam_max = torch.maximum(mid + sqrt_d, mid - sqrt_d)
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam_max, min=0.0)))

    valid = valid_in & det_ok & (depth > NEAR_Z)
    px, py = mean_pix[:, 0], mean_pix[:, 1]

    def rect(r):
        # float -> int casts truncate toward zero, like the CUDA getRect
        rmin_x = torch.clamp(((px - r) / cfg.tile_w).to(torch.int32), 0, gx_grid)
        rmin_y = torch.clamp(((py - r) / cfg.tile_h).to(torch.int32) - t0, 0, gy_grid)
        rmax_x = torch.clamp(((px + r + cfg.tile_w - 1) / cfg.tile_w).to(torch.int32), 0, gx_grid)
        rmax_y = torch.clamp(((py + r + cfg.tile_h - 1) / cfg.tile_h).to(torch.int32) - t0,
                             0, gy_grid)
        return tuple(v.long() for v in (rmin_x, rmin_y, rmax_x, rmax_y))

    rect3 = rect(radius)
    area3 = (rect3[2] - rect3[0]) * (rect3[3] - rect3[1])
    if opacity is not None:
        fac2 = 2.0 * torch.log(torch.clamp(opacity[:, 0], min=1e-12) * 255.0) / 9.0
        bin_radius = radius * torch.sqrt(torch.clamp(fac2, 0.0, 1.0))
        bin_rect = rect(bin_radius)
        bin_area = (bin_rect[2] - bin_rect[0]) * (bin_rect[3] - bin_rect[1])
    else:
        bin_rect, bin_area = rect3, area3

    bin_valid = valid & (bin_area > 0)
    tiles_touched = torch.where(bin_valid, bin_area, torch.zeros_like(bin_area))
    radius = torch.where(valid & (area3 > 0), radius, torch.zeros_like(radius))
    return Preprocessed(mean_pix, radius, tiles_touched, bin_rect, bin_valid)


def bin_instances(pre: Preprocessed, mean_pix: torch.Tensor,
                  conic: torch.Tensor, opacity: torch.Tensor,
                  colors: torch.Tensor, depth: torch.Tensor, width: int,
                  height: int, cfg: RasterConfig, n_batch: int = 1) -> Binned:
    """Expand Gaussians into depth-sorted, tile-grouped, chunk-aligned
    instance buffers.  Pure bookkeeping: call it without autograd; the
    rasterizer's backward reduces the per-instance gradients itself
    (api.py).

    With ``n_batch`` B > 1 the [P] axis is a flattened batch of B cameras'
    Gaussians (camera b owns rows [b P/B, (b + 1) P/B)), each preprocessed
    against its own image: camera b's tile rect, clamped to its own gy tile
    rows by ``preprocess``, is shifted by b * gy rows into one virtual grid
    of B * gx * gy tiles (the JAX package's rule), so no footprint reaches
    another camera's tiles and the kernels composite every camera in one
    launch.

    Order: one stable sort on the int64 key ``tile << 32 | float_bits(depth)``
    over the expansion order (gid ascending) -- the CUDA radix-sort order and
    the JAX package's ``sort_mode="exact"`` order.  Tile ids of different
    cameras are disjoint, so one sort gives each camera its own order (the
    JAX package sorts each camera's segment apart: one sort over the batch
    was superlinear on the TPU).  The key needs depth > 0 for every binned
    instance (negative floats' bit patterns do not sort); ``preprocess``
    guarantees depth > NEAR_Z."""
    dev = mean_pix.device
    p = mean_pix.shape[0]
    if n_batch < 1 or p % n_batch:
        raise ValueError(f"{p} Gaussians do not split into {n_batch} cameras")
    gx_grid, gy_grid = cfg.grid(width, height)
    num_tiles = n_batch * gx_grid * gy_grid
    ch = cfg.chunk

    counts_g = pre.tiles_touched
    offsets = torch.cumsum(counts_g, 0) - counts_g
    per_camera = counts_g.reshape(n_batch, -1).sum(1)
    # the one host sync: the total and B * the largest camera's count
    total, bound = torch.stack([per_camera.sum(), per_camera.max() * n_batch]).tolist()

    # --- duplicateWithKeys ---
    gid = torch.repeat_interleave(torch.arange(p, device=dev), counts_g,
                                  output_size=total)
    within = torch.arange(total, device=dev) - offsets[gid]
    rmin_x, rmin_y, rmax_x, _ = pre.rect
    if n_batch > 1:
        # camera b's rows into its slice of the virtual grid, after the clamp
        rmin_y = rmin_y + torch.arange(p, device=dev) // (p // n_batch) * gy_grid
    rect_w = torch.clamp(rmax_x - rmin_x, min=1)[gid]
    tile_id = (rmin_y[gid] + within // rect_w) * gx_grid + rmin_x[gid] + within % rect_w
    dbits = depth.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)[gid]
    key = (tile_id << 32) | dbits
    _, order = torch.sort(key, stable=True)
    gid_sorted = gid[order]
    tile_sorted = tile_id[order]

    # --- identifyTileRanges -> chunk-aligned layout ---
    counts = torch.bincount(tile_sorted, minlength=num_tiles)
    tile_start = torch.cumsum(counts, 0) - counts
    nchunks = torch.clamp((counts + ch - 1) // ch, min=1)
    chunk_start = torch.cumsum(nchunks, 0) - nchunks
    # upper bound of sum(nchunks): sum(floor(c/ch) + 1) <= total/ch + T
    tc = total // ch + num_tiles
    chunk_ids = torch.arange(tc, device=dev)
    tile_of_chunk = torch.clamp(
        torch.searchsorted(chunk_start, chunk_ids, right=True) - 1, 0, num_tiles - 1)
    chunk_in_tile = chunk_ids - chunk_start[tile_of_chunk]
    used = chunk_in_tile < nchunks[tile_of_chunk]
    chunk_in_tile = torch.where(used, chunk_in_tile, torch.full_like(chunk_in_tile, -1))

    # slot (chunk, lane) -> position in the sorted stream
    lane = torch.arange(ch, device=dev)[None, :]
    off_in_tile = chunk_in_tile[:, None] * ch + lane
    slot_ok = used[:, None] & (off_in_tile < counts[tile_of_chunk][:, None])
    # empty slots point one past the stream, at gid P (also when total is 0)
    pos = torch.where(slot_ok, tile_start[tile_of_chunk][:, None] + off_in_tile,
                      torch.full_like(off_in_tile, total))
    gid_slot = torch.cat([gid_sorted, gid_sorted.new_full((1,), p)])[pos]

    # each instance's slot, in expansion order (a permutation scatter: the
    # indices are distinct, so the result does not depend on write order)
    rank = torch.arange(total, device=dev) - tile_start[tile_sorted]
    slot_sorted = (chunk_start[tile_sorted] + rank // ch) * ch + rank % ch
    slot_of_instance = torch.empty(total, dtype=torch.int64, device=dev)
    slot_of_instance[order] = slot_sorted

    ones = torch.ones((p, 1), dtype=mean_pix.dtype, device=dev)
    pack = torch.cat([mean_pix, conic, opacity, ones, torch.zeros_like(ones),
                      colors], dim=-1)
    pack = torch.cat([pack, torch.zeros_like(pack[:1])], 0)       # row P = 0
    rows = pack[gid_slot].transpose(1, 2)                          # [TC, 18, CH]
    payload = torch.cat([rows, torch.zeros((tc, PAYLOAD_ROWS - rows.shape[1], ch),
                                           dtype=rows.dtype, device=dev)], 1)
    return Binned(payload=payload.contiguous(),
                  tile_of_chunk=tile_of_chunk.to(torch.int32),
                  chunk_in_tile=chunk_in_tile.to(torch.int32),
                  chunk_start=chunk_start.to(torch.int32),
                  nchunks=nchunks.to(torch.int32),
                  gid=gid_slot, slot_of_instance=slot_of_instance,
                  gauss_offset=offsets, gauss_count=counts_g,
                  num_rendered=total, num_tiles=num_tiles, num_rendered_bound=bound)


def pixel_coords(num_tiles: int, width: int, cfg: RasterConfig, device, row0: int = 0,
                 grid_y: int | None = None):
    """(px, py) [T, PIX] float pixel coordinates of every tile pixel, each
    in its own image: of a grid of images of ``grid_y`` tile rows stacked
    (tile t's row within its image is (t // gx) % grid_y, the kernels'
    ``tile_origin``), or of one image's rows from ``row0`` on (``grid_y``
    None: the layout is one image)."""
    gx_grid, _ = cfg.grid(width, 1)
    gy_grid = grid_y or -(-num_tiles // gx_grid)
    t = torch.arange(num_tiles, device=device)[:, None]
    i = torch.arange(cfg.tile_pix, device=device)[None, :]
    px = (t % gx_grid) * cfg.tile_w + i % cfg.tile_w
    py = row0 + ((t // gx_grid) % gy_grid) * cfg.tile_h + i // cfg.tile_w
    return px.to(torch.float32), py.to(torch.float32)


def assemble_image(tile_buf: torch.Tensor, bg: torch.Tensor, width: int,
                   height: int, cfg: RasterConfig, n_batch: int | None = None):
    """tile_buf [T, PIX, 16] -> (image [10, H, W], final_T [H, W]), blending
    the background as forward.cu:397-398: out = C + T_final * bg.  With
    ``n_batch`` B, tile_buf [B * T, PIX, 16] -> ([B, 10, H, W], [B, H, W])."""
    gx_grid, gy_grid = cfg.grid(width, height)
    t_final = tile_buf[:, :, CH_TRANS]
    img = tile_buf[:, :, :NUM_CHANNELS] + t_final[:, :, None] * bg[None, None, :NUM_CHANNELS]
    img = img.reshape(-1, gy_grid, gx_grid, cfg.tile_h, cfg.tile_w, NUM_CHANNELS)
    img = img.permute(0, 5, 1, 3, 2, 4).reshape(
        -1, NUM_CHANNELS, gy_grid * cfg.tile_h, gx_grid * cfg.tile_w)
    t_final = t_final.reshape(-1, gy_grid, gx_grid, cfg.tile_h, cfg.tile_w)
    t_final = t_final.permute(0, 1, 3, 2, 4).reshape(
        -1, gy_grid * cfg.tile_h, gx_grid * cfg.tile_w)
    img, t_final = img[:, :, :height, :width], t_final[:, :height, :width]
    return (img[0], t_final[0]) if n_batch is None else (img, t_final)


def disassemble_cotangent(g_img: torch.Tensor, g_t: torch.Tensor,
                          bg: torch.Tensor, width: int, height: int,
                          cfg: RasterConfig) -> torch.Tensor:
    """Cotangent of ``assemble_image`` -> tile-buffer cotangent [T, PIX, 16]
    (g_img [10, H, W], g_t [H, W]; or [B, 10, H, W], [B, H, W] ->
    [B * T, PIX, 16]).  Channel 15 (final T) takes g_T plus the background
    term sum_c g_c bg_c."""
    gx_grid, gy_grid = cfg.grid(width, height)
    hp, wp = gy_grid * cfg.tile_h, gx_grid * cfg.tile_w
    g_img = torch.nn.functional.pad(g_img, (0, wp - width, 0, hp - height))
    g_t = torch.nn.functional.pad(g_t, (0, wp - width, 0, hp - height))
    gi = g_img.reshape(-1, NUM_CHANNELS, gy_grid, cfg.tile_h, gx_grid, cfg.tile_w)
    gi = gi.permute(0, 2, 4, 3, 5, 1).reshape(-1, cfg.tile_pix, NUM_CHANNELS)
    gt = g_t.reshape(-1, gy_grid, cfg.tile_h, gx_grid, cfg.tile_w)
    gt = gt.permute(0, 1, 3, 2, 4).reshape(-1, cfg.tile_pix)
    g15 = gt + torch.einsum("tpc,c->tp", gi, bg[:NUM_CHANNELS])
    zeros = torch.zeros(gi.shape[:2] + (PAD_CHANNELS - NUM_CHANNELS - 1,),
                        dtype=gi.dtype, device=gi.device)
    return torch.cat([gi, zeros, g15[..., None]], dim=-1).contiguous()
