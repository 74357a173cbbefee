"""The rasterizer's kernel wrappers: the compositing forward and backward
(``gaussianhaircut_torch/csrc/raster_{fwd,bwd}.cu``, the port of
``gaussianhaircut_tpu/ops/rasterize/pallas_core.py``), the forward's
fixed-cost probe (``csrc/raster_probe.cu``, the port of
``tools/tpu_profile_r4.py: _h_fixed_probe``) and ``warp_masks``, which
writes out the per-warp cull all three compute while staging
(``csrc/raster_common.cuh``) so that it can be held against its plain
mirror.  ``gaussianhaircut_torch/kernels.py`` builds, loads and launches
them, and counts each launch under its C entry point.

The compositing kernels need tiles whose width is a multiple of 8 and
height a multiple of 4 (each warp owns an 8x4 pixel block), at most 1024 pixels, and
chunks of a multiple of 32 instances.  Blocks take tiles heaviest first
(``heavy_first``, computed by each wrapper), which changes no output.

A grid may hold a batch of B images of the same size, stacked as a
virtual grid of B * gy tile rows (camera b's rows [b * gy, (b + 1) * gy)):
the kernels take each tile's row within its image as (tile // gx) % gy,
as the TPU kernels do, and B is the number of tiles over gx * gy
(``rasterize_batched``).  Or a grid may cover a window of one image's rows,
from ``row0`` (a whole number of tile rows) on: the pixel coordinates stay
the image's, so a window's tiles are the whole image's render bit for bit
(the tile-row mesh step, ``parallel/tile_parallel.py``).  Not both.  Blocks
take the tiles of all B images heaviest first.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain PyTorch version from ``plain_core.py``.
"""
from __future__ import annotations

import torch

from gaussianhaircut_torch import kernels
from gaussianhaircut_torch.ops.rasterize import common as C
from gaussianhaircut_torch.ops.rasterize import plain_core


def blocks_per_sm(name: str, cfg: C.RasterConfig) -> int:
    """Blocks of compositing library ``name``'s kernel resident on one SM at
    ``cfg``'s launch shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return kernels.query(name + "_blocks_per_sm", cfg.tile_w, cfg.tile_h, cfg.chunk)


def _check_layout(payload, chunk_start, nchunks, cfg):
    if cfg.tile_pix > 1024 or cfg.tile_w % 8 or cfg.tile_h % 4:
        raise ValueError(f"{cfg.tile_w}x{cfg.tile_h} tile: the kernels need a width "
                         "that is a multiple of 8, a height that is a multiple of 4 "
                         "and at most 1024 pixels")
    if cfg.chunk % 32:
        raise ValueError(f"chunk {cfg.chunk} is not a multiple of 32")
    kernels.check_arg("payload", payload, torch.float32,
                      (payload.shape[0], C.PAYLOAD_ROWS, cfg.chunk))
    kernels.check_arg("chunk_start", chunk_start, torch.int32, device=payload.device)
    kernels.check_arg("nchunks", nchunks, torch.int32, chunk_start.shape, payload.device)


def _grid(num_tiles: int, width: int, height: int, cfg: C.RasterConfig,
         row0: int = 0) -> tuple[int, int]:
    """(gx, gy), the tile columns and rows of one image, of a layout of
    ``num_tiles`` tiles: a whole number B >= 1 of images, and ``row0`` only
    with B = 1.  Raises ValueError otherwise."""
    gx, gy = cfg.grid(width, height)
    if num_tiles < 1 or num_tiles % (gx * gy):
        raise ValueError(f"{num_tiles} tile ranges for images of {gx}x{gy} tiles")
    if row0 < 0 or row0 % cfg.tile_h:
        raise ValueError(f"row0 {row0} is not a whole number of {cfg.tile_h}-row tiles")
    if row0 and num_tiles > gx * gy:
        raise ValueError(f"row0 {row0} with a batch of {num_tiles // (gx * gy)} images: "
                         "a grid is a batch of whole images or a window of one")
    return gx, gy


def heavy_first(nchunks: torch.Tensor) -> torch.Tensor:
    """[T] int32: the order in which the kernels' blocks take tiles, by
    descending chunk count, ties by tile index (a stable sort on the
    tensors' device, no host sync).  It changes no output, only which tiles
    start in the last wave."""
    return torch.sort(nchunks, descending=True, stable=True).indices.to(torch.int32)


def raster_fwd(payload: torch.Tensor, chunk_start: torch.Tensor,
               nchunks: torch.Tensor, width: int, height: int,
               cfg: C.RasterConfig, row0: int = 0) -> torch.Tensor:
    """Compositing forward -> tile_buf [T, PIX, 16]."""
    num_tiles = chunk_start.shape[0]
    gx, gy = _grid(num_tiles, width, height, cfg, row0)
    if not payload.is_cuda:
        return plain_core.raster_fwd_plain(payload, chunk_start, nchunks,
                                           width, height, cfg, row0=row0)
    _check_layout(payload, chunk_start, nchunks, cfg)
    tile_buf = torch.empty((num_tiles, cfg.tile_pix, C.PAD_CHANNELS),
                           dtype=torch.float32, device=payload.device)
    tile_order = heavy_first(nchunks)
    kernels.launch("raster_fwd", payload.data_ptr(), chunk_start.data_ptr(),
                   nchunks.data_ptr(), tile_order.data_ptr(), tile_buf.data_ptr(), num_tiles,
                   gx, gy, cfg.tile_w, cfg.tile_h, cfg.chunk, row0,
                   torch.cuda.current_stream(payload.device).cuda_stream)
    return tile_buf


def warp_masks(payload: torch.Tensor, chunk_start: torch.Tensor,
               nchunks: torch.Tensor, width: int, height: int,
               cfg: C.RasterConfig, row0: int = 0) -> torch.Tensor:
    """The per-warp cull as the kernels' staging computes it -> masks
    [TC, CH] int64 in [0, 2^32) (0 for chunks in no tile's range): the
    card's side of ``plain_core.warp_masks_plain``."""
    num_tiles = chunk_start.shape[0]
    gx, gy = _grid(num_tiles, width, height, cfg, row0)
    if not payload.is_cuda:
        return plain_core.warp_masks_plain(payload, chunk_start, nchunks, width, cfg,
                                           row0=row0, grid_y=gy)
    _check_layout(payload, chunk_start, nchunks, cfg)
    masks = torch.zeros((payload.shape[0], cfg.chunk), dtype=torch.int32,
                        device=payload.device)
    kernels.launch("raster_warp_masks", payload.data_ptr(), chunk_start.data_ptr(),
                   nchunks.data_ptr(), masks.data_ptr(), num_tiles, gx, gy, cfg.tile_w,
                   cfg.tile_h, cfg.chunk, row0,
                   torch.cuda.current_stream(payload.device).cuda_stream)
    return masks.long() & 0xFFFFFFFF


def raster_bwd(payload: torch.Tensor, chunk_start: torch.Tensor,
               nchunks: torch.Tensor, tile_buf: torch.Tensor,
               gbuf: torch.Tensor, width: int, height: int,
               cfg: C.RasterConfig, row0: int = 0) -> torch.Tensor:
    """Compositing backward -> dpay [TC, 16, CH] (zero where no tile
    reaches)."""
    num_tiles = chunk_start.shape[0]
    gx, gy = _grid(num_tiles, width, height, cfg, row0)
    if not payload.is_cuda:
        return plain_core.raster_bwd_plain(payload, chunk_start, nchunks,
                                           tile_buf, gbuf, width, height, cfg,
                                           row0=row0)
    _check_layout(payload, chunk_start, nchunks, cfg)
    buf_shape = (num_tiles, cfg.tile_pix, C.PAD_CHANNELS)
    kernels.check_arg("tile_buf", tile_buf, torch.float32, buf_shape, payload.device)
    kernels.check_arg("gbuf", gbuf, torch.float32, buf_shape, payload.device)
    dpay = torch.zeros((payload.shape[0], C.GRAD_ROWS, cfg.chunk),
                       dtype=torch.float32, device=payload.device)
    tile_order = heavy_first(nchunks)
    kernels.launch("raster_bwd", payload.data_ptr(), chunk_start.data_ptr(),
                   nchunks.data_ptr(), tile_order.data_ptr(), tile_buf.data_ptr(), gbuf.data_ptr(),
                   dpay.data_ptr(), num_tiles, gx, gy, cfg.tile_w, cfg.tile_h, cfg.chunk,
                   row0, torch.cuda.current_stream(payload.device).cuda_stream)
    return dpay


def raster_probe(payload: torch.Tensor, chunk_start: torch.Tensor,
                 nchunks: torch.Tensor, width: int, height: int,
                 cfg: C.RasterConfig, grid_only: bool = False) -> torch.Tensor:
    """The forward's fixed-cost probe -> tile_buf [T, PIX, 16], every entry
    of a tile the sum of payload row 0 over the tile's chunks.  With
    ``grid_only`` the kernel stages and reads no payload (each entry is the
    tile's chunk count); that variant runs on CUDA tensors only and has no
    plain version: it is timed, not compared."""
    if not payload.is_cuda:
        if grid_only:
            raise ValueError("raster_probe: the grid-only variant runs on "
                             "CUDA tensors only")
        return plain_core.raster_probe_plain(payload, chunk_start, nchunks, cfg)
    _check_layout(payload, chunk_start, nchunks, cfg)
    num_tiles = chunk_start.shape[0]
    gx, gy = _grid(num_tiles, width, height, cfg)
    if num_tiles != gx * gy:
        raise ValueError(f"raster_probe: {num_tiles} tile ranges for one image of "
                         f"{gx}x{gy} tiles")
    tile_buf = torch.empty((num_tiles, cfg.tile_pix, C.PAD_CHANNELS),
                           dtype=torch.float32, device=payload.device)
    tile_order = heavy_first(nchunks)
    kernels.launch("raster_probe_grid_only" if grid_only else "raster_probe",
                   payload.data_ptr(), chunk_start.data_ptr(), nchunks.data_ptr(),
                   tile_order.data_ptr(), tile_buf.data_ptr(), num_tiles, gx, cfg.tile_w,
                   cfg.tile_h, cfg.chunk, torch.cuda.current_stream(payload.device).cuda_stream)
    return tile_buf
