"""Build and launch of the port's hand-written CUDA kernels, and the
wrappers of the rasterizer's: the compositing forward and backward
(``gaussianhaircut_torch/csrc/raster_{fwd,bwd}.cu``, the port of
``gaussianhaircut_tpu/ops/rasterize/pallas_core.py``), the forward's
fixed-cost probe (``csrc/raster_probe.cu``, the port of
``tools/tpu_profile_r4.py: _h_fixed_probe``) and ``warp_masks``, which
writes out the per-warp cull all three compute while staging
(``csrc/raster_common.cuh``) so that it can be held against its plain
mirror.  Stage 2's optimizer tail (``csrc/optim_tail.cu``) and the
precompute (``csrc/precompute.cu``) are built and launched here too; their
wrappers are ``train/optim_tail.py`` and ``ops/precompute.py``.

The compositing kernels need tiles whose width is a multiple of 8 and
height a multiple of 4 (each warp owns an 8x4 pixel block), at most 1024 pixels, and
chunks of a multiple of 32 instances.  Blocks take tiles heaviest first
(``heavy_first``, computed by each wrapper), which changes no output.

Build: each source is compiled by ``nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared`` into its own shared library with a plain C
interface (the compilers run at once), at first use, into
``gaussianhaircut_torch/csrc/build/`` (listed in ``.gitignore``); the
libraries are loaded with ``ctypes``.  Several processes may build at once
(each writes its own temporary file and renames it into place).

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
the plain PyTorch version from ``plain_core.py``.  Each launch adds one to
``launches[name]``, keyed by the C entry point it calls; nothing else
touches the counts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

from gaussianhaircut_torch.ops.rasterize import common as C
from gaussianhaircut_torch.ops.rasterize import plain_core

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
SOURCES = {"raster_fwd": "raster_fwd.cu", "raster_bwd": "raster_bwd.cu",
           "raster_probe": "raster_probe.cu", "optim_tail": "optim_tail.cu",
           "precompute": "precompute.cu"}
# C entry points: name -> (library, argument types before the stream); each
# takes the stream last and returns cudaGetLastError()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY_POINTS = {
    "raster_fwd": ("raster_fwd", [_P] * 5 + [_I] * 7),
    "raster_warp_masks": ("raster_fwd", [_P] * 4 + [_I] * 7),
    "raster_bwd": ("raster_bwd", [_P] * 7 + [_I] * 7),
    "raster_probe": ("raster_probe", [_P] * 5 + [_I] * 5),
    "raster_probe_grid_only": ("raster_probe", [_P] * 5 + [_I] * 5),
    "optim_tail_reduce": ("optim_tail", [_P, _I, _P, _P]),
    "optim_tail_finalize": ("optim_tail", [_P, _P, _I, _P, _P] + [_F] * 3),
    "optim_tail_update": ("optim_tail", [_P, _I, _P] + [_F] * 9),
    "precompute_fwd": ("precompute", [_P] * 13 + [_I] * 5 + [_F]),
    "precompute_bwd": ("precompute", [_P] * 17 + [_I] * 5 + [_F]),
    "precompute_cam_reduce": ("precompute", [_P, _I, _P]),
}
_HEADERS = ("raster_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

launches = {name: 0 for name in ENTRY_POINTS}
_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the compositing kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel not yet built (one nvcc per source, all started
    together) and load them.  Returns {name: compiler output}."""
    logs = {}
    with _build_lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, src in SOURCES.items():
            if name in _libs:
                continue
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            # a temporary name of this process's own: the ranks of a mesh
            # may build into one empty directory at once; the rename is
            # atomic, so a loader sees a whole library or none
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, os.path.join(_CSRC, src)]
            procs[name] = (out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (out, tmp, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        for name in SOURCES:
            if name not in _libs:
                _libs[name] = _load(name)
    return logs


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(_lib_path(name))
    for entry, (lib_name, argtypes) in ENTRY_POINTS.items():
        if lib_name == name:
            fn = getattr(lib, entry)
            fn.argtypes = argtypes + [_P]
            fn.restype = ctypes.c_int
    occupancy = getattr(lib, name + "_blocks_per_sm", None)   # the compositing kernels'
    if occupancy is not None:
        occupancy.argtypes = [_I] * 3
        occupancy.restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``SOURCES``), built if need be."""
    if name not in _libs:
        build()
    return _libs[name]


def blocks_per_sm(name: str, cfg: C.RasterConfig) -> int:
    """Blocks of compositing library ``name``'s kernel resident on one SM at
    ``cfg``'s launch shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return getattr(library(name), name + "_blocks_per_sm")(cfg.tile_w, cfg.tile_h, cfg.chunk)


def _check(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_layout(payload, chunk_start, nchunks, cfg):
    if cfg.tile_pix > 1024 or cfg.tile_w % 8 or cfg.tile_h % 4:
        raise ValueError(f"{cfg.tile_w}x{cfg.tile_h} tile: the kernels need a width "
                         "that is a multiple of 8, a height that is a multiple of 4 "
                         "and at most 1024 pixels")
    if cfg.chunk % 32:
        raise ValueError(f"chunk {cfg.chunk} is not a multiple of 32")
    _check("payload", payload, torch.float32,
           (payload.shape[0], C.PAYLOAD_ROWS, cfg.chunk))
    _check("chunk_start", chunk_start, torch.int32)
    _check("nchunks", nchunks, torch.int32, chunk_start.shape)
    for t in (chunk_start, nchunks):
        if t.device != payload.device:
            raise ValueError("kernel inputs lie on different devices")


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


def launch(entry: str, *args) -> None:
    """Call C entry point ``entry`` (a key of ``ENTRY_POINTS``) with ``args``
    and the stream last; raises on a non-zero return."""
    err = getattr(library(ENTRY_POINTS[entry][0]), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    launches[entry] += 1


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
    launch("raster_fwd", payload.data_ptr(), chunk_start.data_ptr(),
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
    launch("raster_warp_masks", payload.data_ptr(), chunk_start.data_ptr(),
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
    _check("tile_buf", tile_buf, torch.float32, buf_shape)
    _check("gbuf", gbuf, torch.float32, buf_shape)
    dpay = torch.zeros((payload.shape[0], C.GRAD_ROWS, cfg.chunk),
                       dtype=torch.float32, device=payload.device)
    tile_order = heavy_first(nchunks)
    launch("raster_bwd", payload.data_ptr(), chunk_start.data_ptr(),
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
    launch("raster_probe_grid_only" if grid_only else "raster_probe",
           payload.data_ptr(), chunk_start.data_ptr(), nchunks.data_ptr(),
           tile_order.data_ptr(), tile_buf.data_ptr(), num_tiles, gx, cfg.tile_w,
           cfg.tile_h, cfg.chunk, torch.cuda.current_stream(payload.device).cuda_stream)
    return tile_buf
