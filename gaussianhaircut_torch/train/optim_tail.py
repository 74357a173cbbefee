"""Stage 2's optimizer tail in one pass: the NaN guard, the global-norm clip,
AdamW and the EMA of the denoiser over every parameter leaf.

On the card, ``adamw_tail_`` launches ``csrc/optim_tail.cu`` three times
(reduce, finalize, update) over one table of up to ``MAX_LEAVES`` leaves,
where the per-leaf composition launched some 26 kernels per leaf and 4 more
per EMA leaf.  On the CPU it runs ``adamw_tail_plain_``, that composition:
``optim.grads_are_finite``, ``optim.clip_by_global_norm``,
``optim.adamw_update``, the guard's ``torch.where``, ``optim.where_ok`` and
the EMA loop, which the CPU tests hold against the JAX package.  Both paths
give the same floats but for the grouping of the norm's sum (the kernel sums
it in float64).

Both update in place: the parameters, the EMA and the optimizer state's
``mu``, ``nu`` and ``count`` tensors.  A step with a non-finite gradient
keeps the parameters, the moments and the count, and still moves the EMA.

Each launch adds one to ``cuda_core.launches`` under its C entry point
(``optim_tail_reduce``, ``optim_tail_finalize``, ``optim_tail_update``).
"""
from __future__ import annotations

import bisect
import ctypes
from typing import NamedTuple

import torch

from gaussianhaircut_torch.ops.rasterize import cuda_core
from gaussianhaircut_torch.train import optim

# csrc/optim_tail.cu's constants, checked against the library at first use:
# elements per chunk (a multiple of 4), threads per block, resident blocks
# per SM (the kernels' launch bounds), leaves per table
CHUNK = 4096
THREADS = 256
BLOCKS_PER_SM = 4
MAX_LEAVES = 400


class _Table(ctypes.Structure):
    """csrc/optim_tail.cu's ``TailTable``, passed by value to the kernels."""
    _fields_ = [("num_leaves", ctypes.c_int), ("num_chunks", ctypes.c_int),
                ("chunk_start", ctypes.c_int * (MAX_LEAVES + 1)),
                ("numel", ctypes.c_longlong * MAX_LEAVES),
                *((name, ctypes.c_void_p * MAX_LEAVES) for name in "gpmve")]


class TailResult(NamedTuple):
    grad_norm: torch.Tensor     # device scalar: the gradients' global norm before the clip
    fused_leaves: int           # leaves the kernel covered (0 on the plain path)


def chunk_plan(sizes) -> list[int]:
    """The chunk table of leaves of element counts ``sizes`` ->
    chunk_start: leaf i owns the chunks [chunk_start[i], chunk_start[i + 1])
    of ``CHUNK`` elements each, its last one short.  One table spans every
    leaf, so each kernel launches once; more than ``MAX_LEAVES`` leaves
    raise."""
    if len(sizes) > MAX_LEAVES:
        raise ValueError(f"optim_tail: {len(sizes)} leaves, the table holds {MAX_LEAVES}")
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // CHUNK))
    return starts


def chunk_ranges(sizes, chunk_start: list[int]) -> list[tuple[int, int, int]]:
    """(leaf, first element, length) of each chunk, found as the kernels find
    them (``chunk_of``): chunk c belongs to the last leaf whose chunk_start
    is at most c."""
    out = []
    for c in range(chunk_start[-1]):
        i = bisect.bisect_right(chunk_start, c, hi=len(sizes)) - 1
        offset = (c - chunk_start[i]) * CHUNK
        out.append((i, offset, min(CHUNK, sizes[i] - offset)))
    return out


@torch.no_grad()
def adamw_tail_(params: dict, grads: dict, opt_state: optim.AdamState, ema_pairs, lr: float,
                clip: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.01, decay: float = 0.995) -> TailResult:
    """One AdamW step of ``params`` (name -> leaf) from ``grads`` (name ->
    gradient), in place, behind the NaN guard and, with ``clip`` > 0, the
    global-norm clip; then ``e = decay * e + (1 - decay) * p`` for each
    (e, p) of ``ema_pairs``, every p one of ``params``' leaves.  CUDA
    parameters launch the kernels (``tail_tables`` then refuses a gradient,
    moment, EMA or count elsewhere), CPU parameters run
    ``adamw_tail_plain_``."""
    if not next(iter(params.values())).is_cuda:
        return TailResult(adamw_tail_plain_(params, grads, opt_state, ema_pairs, lr, clip, b1,
                                            b2, eps, weight_decay, decay), 0)
    table, grid = tail_tables(params, grads, opt_state, ema_pairs)
    return TailResult(launch_tail(table, grid, opt_state.count, lr, clip, b1, b2, eps,
                                  weight_decay, decay), len(params))


@torch.no_grad()
def adamw_tail_plain_(params: dict, grads: dict, opt_state: optim.AdamState, ema_pairs,
                      lr: float, clip: float, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8, weight_decay: float = 0.01,
                      decay: float = 0.995) -> torch.Tensor:
    """``adamw_tail_``'s plain version, on any device: the per-leaf
    composition of ``optim``'s helpers.  Returns the global norm."""
    ok = optim.grads_are_finite(grads)
    if clip > 0:
        grads, gnorm = optim.clip_by_global_norm(grads, clip)
    else:
        gnorm = optim.global_norm(grads)
    updates, new = optim.adamw_update(grads, opt_state, {n: p.detach() for n, p in params.items()},
                                      lr, b1, b2, eps, weight_decay)
    # torch.where, not a multiplicative mask (0 * NaN = NaN); a skipped step
    # keeps the moments and the count
    for n, p in params.items():
        p.add_(torch.where(ok, updates[n], torch.zeros_like(updates[n])))
    new = optim.where_ok(ok, new, opt_state)
    for e, p in ema_pairs:
        e.copy_(decay * e + (1.0 - decay) * p)
    for n in params:
        opt_state.mu[n].copy_(new.mu[n])
        opt_state.nu[n].copy_(new.nu[n])
    opt_state.count.copy_(new.count)
    return gnorm


def _ptr(what: str, t: torch.Tensor, device, dtype, shape) -> int:
    if t.dtype is not dtype or t.device != device or t.shape != shape or not t.is_contiguous():
        raise ValueError(f"optim_tail: {what} is {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}; expected "
                         f"contiguous {dtype} {tuple(shape)} on {device}")
    return t.data_ptr()


_layout_checked = False


def _check_layout() -> None:
    """The library's constants and table size against this module's."""
    global _layout_checked
    if _layout_checked:
        return
    fn = cuda_core.library("optim_tail").optim_tail_layout
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 5)()
    fn(out)
    want = (CHUNK, THREADS, BLOCKS_PER_SM, MAX_LEAVES, ctypes.sizeof(_Table))
    if tuple(out) != want:
        raise RuntimeError(f"csrc/optim_tail.cu's layout {tuple(out)} is not the wrapper's "
                           f"{want} (chunk, threads, blocks per SM, leaves, table bytes)")
    _layout_checked = True


def tail_tables(params: dict, grads: dict, opt_state: optim.AdamState,
                ema_pairs) -> tuple[_Table, int]:
    """The kernels' leaf table and grid size for one call, every tensor
    checked (on the parameters' device, float32, the leaf's shape,
    contiguous; the count int32)."""
    device = next(iter(params.values())).device
    f32 = torch.float32
    _ptr("count", opt_state.count, device, torch.int32, ())
    ema = {id(p): e for e, p in ema_pairs}
    if len(ema) != len(ema_pairs) or not ema.keys() <= {id(p) for p in params.values()}:
        raise ValueError("optim_tail: every EMA pair's parameter must be a distinct leaf "
                         "of params")
    t = _Table()
    sizes = [p.numel() for p in params.values()]
    starts = chunk_plan(sizes)
    t.num_leaves, t.num_chunks = len(sizes), starts[-1]
    t.chunk_start[:len(starts)] = starts
    t.numel[:len(sizes)] = sizes
    for i, (n, p) in enumerate(params.items()):
        shape = p.shape
        t.g[i] = _ptr(f"grads[{n!r}]", grads[n], device, f32, shape)
        t.p[i] = _ptr(f"params[{n!r}]", p, device, f32, shape)
        t.m[i] = _ptr(f"mu[{n!r}]", opt_state.mu[n], device, f32, shape)
        t.v[i] = _ptr(f"nu[{n!r}]", opt_state.nu[n], device, f32, shape)
        e = ema.get(id(p))
        t.e[i] = None if e is None else _ptr(f"ema of {n!r}", e, device, f32, shape)
    grid_cap = torch.cuda.get_device_properties(device).multi_processor_count * BLOCKS_PER_SM
    return t, max(1, min(grid_cap, t.num_chunks))


def launch_tail(table: _Table, grid: int, count: torch.Tensor, lr: float, clip: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.01, decay: float = 0.995) -> torch.Tensor:
    """The three kernels on ``tail_tables``' table (reduce, finalize,
    update) on the current stream.  Returns the global norm (a device
    scalar)."""
    _check_layout()
    device = count.device
    part_sq = torch.empty(grid, dtype=torch.float64, device=device)
    part_bad = torch.empty(grid, dtype=torch.int32, device=device)
    scalars = torch.empty(5, dtype=torch.float32, device=device)   # scale, ok, c1, c2, norm
    stream = torch.cuda.current_stream(device).cuda_stream
    cuda_core.launch("optim_tail_reduce", ctypes.addressof(table), grid, part_sq.data_ptr(),
                     part_bad.data_ptr(), stream)
    cuda_core.launch("optim_tail_finalize", part_sq.data_ptr(), part_bad.data_ptr(), grid,
                     count.data_ptr(), scalars.data_ptr(), clip, b1, b2, stream)
    cuda_core.launch("optim_tail_update", ctypes.addressof(table), grid, scalars.data_ptr(),
                     -lr, b1, 1 - b1, b2, 1 - b2, eps, weight_decay, decay, 1.0 - decay,
                     stream)
    return scalars[4]
