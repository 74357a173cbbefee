"""Build, load and launch of the port's hand-written CUDA sources
(``gaussianhaircut_torch/csrc/*.cu``), and the checks every kernel wrapper
makes before a pointer goes to C.  The wrappers stay in their own layers
(``ops/rasterize/cuda_core.py``, ``ops/precompute.py``,
``train/optim_tail.py``) and call down to this module; it imports nothing
of the package.

Build: each source of ``SOURCES`` is compiled by ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` into its own shared library with
a plain C interface (the compilers run at once), at first use, into
``csrc/build/`` (listed in ``.gitignore``); the library's file name carries
a hash of the flags, the source and the shared headers.  Several processes
may build at once (each writes its own temporary file and renames it into
place).  The libraries are loaded with ``ctypes``.

``ENTRY_POINTS`` is the manifest of every ``extern "C" int`` function of
the sources, with its argument types: the launchers, which take the stream
last, return ``cudaGetLastError()`` and run through ``launch``, and the
queries (occupancy and layout), which run through ``query``.  Each launch
adds one to ``launches[entry]``; nothing else touches the counts, and they
are the one record of which kernels ran.  ``tests/test_torch_kernels.py``
holds the manifest against the C signatures.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
SOURCES = {"raster_fwd": "raster_fwd.cu", "raster_bwd": "raster_bwd.cu",
           "raster_probe": "raster_probe.cu", "optim_tail": "optim_tail.cu",
           "precompute": "precompute.cu"}
_HEADERS = ("raster_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


class Entry(NamedTuple):
    library: str            # the key of SOURCES whose library holds it
    argtypes: tuple         # ctypes types of its arguments, the stream's left out
    launcher: bool = True   # takes the stream last; False for a query


# every extern "C" int of csrc/*.cu; a pointer of any type (a TailTable's
# too) is a c_void_p
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY_POINTS = {
    "raster_fwd": Entry("raster_fwd", (_P,) * 5 + (_I,) * 7),
    "raster_warp_masks": Entry("raster_fwd", (_P,) * 4 + (_I,) * 7),
    "raster_fwd_blocks_per_sm": Entry("raster_fwd", (_I,) * 3, launcher=False),
    "raster_bwd": Entry("raster_bwd", (_P,) * 7 + (_I,) * 7),
    "raster_bwd_blocks_per_sm": Entry("raster_bwd", (_I,) * 3, launcher=False),
    "raster_probe": Entry("raster_probe", (_P,) * 5 + (_I,) * 5),
    "raster_probe_grid_only": Entry("raster_probe", (_P,) * 5 + (_I,) * 5),
    "raster_probe_blocks_per_sm": Entry("raster_probe", (_I,) * 3, launcher=False),
    "optim_tail_layout": Entry("optim_tail", (_P,), launcher=False),
    "optim_tail_reduce": Entry("optim_tail", (_P, _I, _P, _P)),
    "optim_tail_finalize": Entry("optim_tail", (_P, _P, _I, _P, _P) + (_F,) * 3),
    "optim_tail_update": Entry("optim_tail", (_P, _I, _P) + (_F,) * 9),
    "precompute_layout": Entry("precompute", (_P,), launcher=False),
    "precompute_fwd": Entry("precompute", (_P,) * 13 + (_I,) * 5 + (_F,)),
    "precompute_bwd": Entry("precompute", (_P,) * 17 + (_I,) * 5 + (_F,)),
    "precompute_cam_reduce": Entry("precompute", (_P, _I, _P)),
}

launches = {name: 0 for name, e in ENTRY_POINTS.items() if e.launcher}
_libs: dict[str, ctypes.CDLL] = {}
_launchers: dict = {}
_layouts_checked: set[str] = set()
_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> dict[str, str]:
    """Compile every source not yet built (one nvcc per source, all started
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
    """Library ``name`` loaded, every entry point of it in ``ENTRY_POINTS``
    bound to its argument types and an int result."""
    lib = ctypes.CDLL(_lib_path(name))
    for entry, e in ENTRY_POINTS.items():
        if e.library == name:
            fn = getattr(lib, entry)
            fn.argtypes = list(e.argtypes) + ([_P] if e.launcher else [])
            fn.restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``SOURCES``), built if need be."""
    if name not in _libs:
        build()
    return _libs[name]


def _function(entry: str):
    return getattr(library(ENTRY_POINTS[entry].library), entry)


def launch(entry: str, *args) -> None:
    """Call launcher ``entry`` (a key of ``ENTRY_POINTS``) with ``args``, the
    stream last; raises on a non-zero return, else counts the launch."""
    try:
        fn = _launchers[entry]
    except KeyError:
        if not ENTRY_POINTS[entry].launcher:
            raise ValueError(f"{entry} is a query, not a launcher") from None
        fn = _launchers[entry] = _function(entry)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    launches[entry] += 1


def query(entry: str, *args) -> int:
    """What query ``entry`` (a key of ``ENTRY_POINTS``) returns for ``args``."""
    if ENTRY_POINTS[entry].launcher:
        raise ValueError(f"{entry} is a launcher, not a query")
    return _function(entry)(*args)


def check_layout(lib: str, want: dict[str, int]) -> None:
    """Library ``lib``'s constants, as its ``<lib>_layout`` query writes them
    in order, against the wrapper's ``want`` ({what: value}, in that order);
    asked once per process.  Raises RuntimeError naming what differs."""
    if lib in _layouts_checked:
        return
    out = (ctypes.c_int * len(want))()
    query(lib + "_layout", out)
    got = dict(zip(want, out))
    if got != want:
        differ = ", ".join(k for k in want if got[k] != want[k])
        raise RuntimeError(f"csrc/{SOURCES[lib]}'s layout {tuple(out)} is not the wrapper's "
                           f"{tuple(want.values())} ({', '.join(want)}): {differ} differ")
    _layouts_checked.add(lib)


ONE = "of one element"


def check_arg(what: str, t: torch.Tensor, dtype: torch.dtype, shape=None, device=None,
              contiguous: bool = True) -> torch.Tensor:
    """``t``, checked before its pointer goes to C: of ``dtype``; on
    ``device``, or on a CUDA device where ``device`` is None (a caller that
    gives a device checks that it is a CUDA device itself); of ``shape`` (a
    tuple), of one element (``ONE``) or of any shape (None); contiguous,
    unless ``contiguous`` is False for a caller that makes it so through
    autograd.  Raises ValueError, one message for every fault."""
    if (t.dtype is dtype and (t.is_cuda if device is None else t.device == device)
            and (shape is None or (t.numel() == 1 if shape is ONE else t.shape == shape))
            and (not contiguous or t.is_contiguous())):
        return t
    want_shape = ("of any shape" if shape is None else shape if shape is ONE
                  else f"of shape {tuple(shape)}")
    raise ValueError(f"{what} is {t.dtype} {tuple(t.shape)} on {t.device}"
                     f"{'' if t.is_contiguous() else ', not contiguous'}; expected a "
                     f"{'contiguous ' if contiguous else ''}{dtype} tensor {want_shape} on "
                     f"{'a CUDA device' if device is None else device}")
