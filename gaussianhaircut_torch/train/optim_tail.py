"""The optimizers of stages 1 and 2, each as one pass over a table of leaves.

Stage 2's tail, ``adamw_tail_``: the NaN guard, the global-norm clip, AdamW
and the EMA of the denoiser over every parameter leaf.

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

Stage 1's Adam, ``adam_guarded``: the NaN guard over the gradients of every
leaf but ``UNGUARDED``, Adam (``optim.B1``, ``B2``, ``EPS``) with a learning
rate per leaf, and Adam on
``Rows``, leaves of N rows (the camera residuals) whose rows each keep their
own count and step only where drawn.  On the card it launches
``csrc/optim_tail.cu``'s ``adam_guard`` and ``adam_update`` once each over
one table of up to ``ADAM_MAX_LEAVES`` leaves, reading the features'
gradients where autograd left them (rows of a stride); on the CPU it runs
``adam_guarded_plain``, the composition of ``optim.grads_are_finite``,
``optim.adam_update``, the guard's ``torch.where``, ``optim.where_ok`` and
``optim.adam_rows_update``.  Both give the same floats.  It writes fresh
tensors: the caller's state is left as it was.  A step with a non-finite
guarded gradient keeps the parameters, the moments and the count; a skipped
rows' step keeps every row.

Each launch adds one to ``kernels.launches`` under its C entry point
(``optim_tail_reduce``, ``optim_tail_finalize``, ``optim_tail_update``;
``optim_tail_adam_guard``, ``optim_tail_adam_update``).
"""
from __future__ import annotations

import bisect
import ctypes
from typing import NamedTuple

import torch

from gaussianhaircut_torch import kernels
from gaussianhaircut_torch.train import optim

# csrc/optim_tail.cu's constants, checked against the library at first use:
# elements per chunk (a multiple of 4), threads per block, resident blocks
# per SM (the kernels' launch bounds), leaves per table (stage 2's, stage 1's)
CHUNK = 4096
THREADS = 256
BLOCKS_PER_SM = 4
MAX_LEAVES = 400
ADAM_MAX_LEAVES = 16


class _Table(ctypes.Structure):
    """csrc/optim_tail.cu's ``TailTable``, passed by value to the kernels."""
    _fields_ = [("num_leaves", ctypes.c_int), ("num_chunks", ctypes.c_int),
                ("chunk_start", ctypes.c_int * (MAX_LEAVES + 1)),
                ("numel", ctypes.c_longlong * MAX_LEAVES),
                *((name, ctypes.c_void_p * MAX_LEAVES) for name in "gpmve")]


class _AdamTable(ctypes.Structure):
    """csrc/optim_tail.cu's ``AdamTable``, passed by value to the kernels."""
    _fields_ = [("num_leaves", ctypes.c_int), ("num_chunks", ctypes.c_int),
                ("chunk_start", ctypes.c_int * (ADAM_MAX_LEAVES + 1)),
                ("numel", ctypes.c_longlong * ADAM_MAX_LEAVES),
                ("g_stride", ctypes.c_longlong * ADAM_MAX_LEAVES),
                ("g_width", ctypes.c_int * ADAM_MAX_LEAVES),
                ("row_width", ctypes.c_int * ADAM_MAX_LEAVES),
                ("guarded", ctypes.c_int * ADAM_MAX_LEAVES),
                ("neg_lr", ctypes.c_float * ADAM_MAX_LEAVES),
                *((name, ctypes.c_void_p * ADAM_MAX_LEAVES)
                  for name in ("g", "p", "m", "v", "p_out", "m_out", "v_out"))]


LAYOUT = {"chunk": CHUNK, "threads": THREADS, "blocks per SM": BLOCKS_PER_SM,
          "leaves": MAX_LEAVES, "table bytes": ctypes.sizeof(_Table),
          "adam leaves": ADAM_MAX_LEAVES, "adam table bytes": ctypes.sizeof(_AdamTable)}


def chunk_plan(sizes, max_leaves: int = MAX_LEAVES) -> list[int]:
    """The chunk table of leaves of element counts ``sizes`` ->
    chunk_start: leaf i owns the chunks [chunk_start[i], chunk_start[i + 1])
    of ``CHUNK`` elements each, its last one short.  One table spans every
    leaf, so each kernel launches once; more than ``max_leaves`` leaves
    raise."""
    if len(sizes) > max_leaves:
        raise ValueError(f"optim_tail: {len(sizes)} leaves, the table holds {max_leaves}")
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
                weight_decay: float = 0.01, decay: float = 0.995) -> torch.Tensor:
    """One AdamW step of ``params`` (name -> leaf) from ``grads`` (name ->
    gradient), in place, behind the NaN guard and, with ``clip`` > 0, the
    global-norm clip; then ``e = decay * e + (1 - decay) * p`` for each
    (e, p) of ``ema_pairs``, every p one of ``params``' leaves.  CUDA
    parameters launch the kernels (``tail_tables`` then refuses a gradient,
    moment, EMA or count elsewhere), CPU parameters run
    ``adamw_tail_plain_``.  Returns the gradients' global norm before the
    clip (a device scalar)."""
    if not next(iter(params.values())).is_cuda:
        return adamw_tail_plain_(params, grads, opt_state, ema_pairs, lr, clip, b1, b2, eps,
                                 weight_decay, decay)
    table, grid = tail_tables(params, grads, opt_state, ema_pairs)
    return launch_tail(table, grid, opt_state.count, lr, clip, b1, b2, eps, weight_decay,
                       decay)


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


def tail_tables(params: dict, grads: dict, opt_state: optim.AdamState,
                ema_pairs) -> tuple[_Table, int]:
    """The kernels' leaf table and grid size for one call, every tensor
    checked (on the parameters' device, float32, the leaf's shape,
    contiguous; the count int32)."""
    device = next(iter(params.values())).device
    f32 = torch.float32
    arg = kernels.check_arg
    arg("optim_tail: count", opt_state.count, torch.int32, (), device)
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
        t.g[i] = arg(f"optim_tail: grads[{n!r}]", grads[n], f32, shape, device).data_ptr()
        t.p[i] = arg(f"optim_tail: params[{n!r}]", p, f32, shape, device).data_ptr()
        t.m[i] = arg(f"optim_tail: mu[{n!r}]", opt_state.mu[n], f32, shape, device).data_ptr()
        t.v[i] = arg(f"optim_tail: nu[{n!r}]", opt_state.nu[n], f32, shape, device).data_ptr()
        e = ema.get(id(p))
        t.e[i] = (None if e is None
                  else arg(f"optim_tail: ema of {n!r}", e, f32, shape, device).data_ptr())
    grid_cap = torch.cuda.get_device_properties(device).multi_processor_count * BLOCKS_PER_SM
    return t, max(1, min(grid_cap, t.num_chunks))


def launch_tail(table: _Table, grid: int, count: torch.Tensor, lr: float, clip: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.01, decay: float = 0.995) -> torch.Tensor:
    """The three kernels on ``tail_tables``' table (reduce, finalize,
    update) on the current stream.  Returns the global norm (a device
    scalar)."""
    kernels.check_layout("optim_tail", LAYOUT)
    device = count.device
    part_sq = torch.empty(grid, dtype=torch.float64, device=device)
    part_bad = torch.empty(grid, dtype=torch.int32, device=device)
    scalars = torch.empty(5, dtype=torch.float32, device=device)   # scale, ok, c1, c2, norm
    stream = torch.cuda.current_stream(device).cuda_stream
    kernels.launch("optim_tail_reduce", ctypes.addressof(table), grid, part_sq.data_ptr(),
                   part_bad.data_ptr(), stream)
    kernels.launch("optim_tail_finalize", part_sq.data_ptr(), part_bad.data_ptr(), grid,
                   count.data_ptr(), scalars.data_ptr(), clip, b1, b2, stream)
    kernels.launch("optim_tail_update", ctypes.addressof(table), grid, scalars.data_ptr(),
                   -lr, b1, 1 - b1, b2, 1 - b2, eps, weight_decay, decay, 1.0 - decay,
                   stream)
    return scalars[4]


# the leaf of stage 1's parameters that the guard leaves out: the viewspace
# port, whose gradient feeds the densify statistics (its lr is 0)
UNGUARDED = "viewspace"


class Rows(NamedTuple):
    """Leaves of N rows for ``adam_guarded`` (the camera residuals), each
    row with its own step count: a row steps where ``drawn`` is above 0, and
    only while ``on`` holds and every gradient of ``grads`` is finite."""
    params: object          # a TensorRecord of [N, ...] leaves
    grads: object
    mu: object
    nu: object
    count: torch.Tensor     # [N] int32
    drawn: torch.Tensor     # [N] float32
    lrs: object             # Python floats by leaf
    on: bool


@torch.no_grad()
def adam_guarded(params, grads, opt_state: optim.AdamState, lrs, rows: Rows | None = None):
    """One guarded Adam step of ``params`` (a TensorRecord; ``grads``, the
    moments and ``lrs``, Python floats, alike) and of ``rows``: the guard
    holds where every gradient but ``UNGUARDED``'s is finite.  CUDA
    parameters launch the kernels (``adam_table`` then refuses a tensor
    elsewhere), CPU parameters run ``adam_guarded_plain``.  Returns (new
    params, new ``AdamState``, ok, (new row params, new rows' ``AdamState``)
    or None), all fresh tensors; ok is a device bool."""
    if not params.values()[0].is_cuda:
        return adam_guarded_plain(params, grads, opt_state, lrs, rows)
    table, outs, grid = adam_table(params, grads, opt_state, lrs, rows)
    new_count, ok, new_row_count = launch_adam(table, grid, opt_state.count, rows)

    def rebuild(out, p, m, v, c):
        return (type(p)(**{n: o[0] for n, o in out.items()}),
                optim.AdamState(type(m)(**{n: o[1] for n, o in out.items()}),
                                type(v)(**{n: o[2] for n, o in out.items()}), c))

    new_params, new_opt = rebuild(outs[0], params, opt_state.mu, opt_state.nu, new_count)
    new_rows = (None if rows is None
                else rebuild(outs[1], rows.params, rows.mu, rows.nu, new_row_count))
    return new_params, new_opt, ok, new_rows


@torch.no_grad()
def adam_guarded_plain(params, grads, opt_state: optim.AdamState, lrs, rows: Rows | None = None):
    """``adam_guarded``'s plain version, on any device: the composition of
    ``optim``'s helpers, with the guard's ``torch.where`` (not a
    multiplicative mask: 0 * NaN = NaN)."""
    ok = optim.grads_are_finite(
        grads.replace(**{UNGUARDED: torch.zeros_like(getattr(grads, UNGUARDED))}))
    updates, new = optim.adam_update(grads, opt_state, lrs)
    new_params = params.map(lambda p, u: p + torch.where(ok, u, torch.zeros_like(u)), updates)
    new = optim.where_ok(ok, new, opt_state)
    new_rows = None
    if rows is not None:
        new_rows = optim.adam_rows_update(
            rows.params, rows.grads, optim.AdamState(rows.mu, rows.nu, rows.count), rows.drawn,
            rows.lrs, rows.on)
    return new_params, new, ok, new_rows


def launch_adam(table: _AdamTable, grid: int, count: torch.Tensor, rows: Rows | None = None):
    """The two kernels on ``adam_table``'s table (adam_guard, adam_update) on
    the current stream, with ``optim``'s B1, B2 and EPS.  Returns (new
    count, ok, the rows' new counts or None): fresh device tensors."""
    kernels.check_layout("optim_tail", LAYOUT)
    device = count.device
    part_bad = torch.empty(2 * grid, dtype=torch.int32, device=device)
    new_count = torch.empty_like(count)
    ok = torch.empty((), dtype=torch.bool, device=device)
    new_row_count, row_args = None, (None, None, None, 0, 0)
    if rows is not None:
        new_row_count = torch.empty_like(rows.count)
        row_args = (rows.drawn.data_ptr(), rows.count.data_ptr(), new_row_count.data_ptr(),
                    len(rows.count), int(bool(rows.on)))
    stream = torch.cuda.current_stream(device).cuda_stream
    kernels.launch("optim_tail_adam_guard", ctypes.addressof(table), grid, part_bad.data_ptr(),
                   stream)
    kernels.launch("optim_tail_adam_update", ctypes.addressof(table), grid, part_bad.data_ptr(),
                   grid, count.data_ptr(), new_count.data_ptr(), ok.data_ptr(), *row_args,
                   optim.B1, 1 - optim.B1, optim.B2, 1 - optim.B2, optim.EPS, stream)
    return new_count, ok, new_row_count


def _grad_rows(what: str, g: torch.Tensor, shape, device) -> tuple[int, int]:
    """(g_width, g_stride) of the table for gradient ``g``, checked: (0, 0)
    where it is contiguous; else, where its rows are contiguous as
    autograd's slices of a concatenation are ([N, 1, 3] and [N, 15, 3] of
    one [N, 16, 3] for the features), the elements per row and the elements
    between rows.  Any other layout is refused."""
    kernels.check_arg(what, g, torch.float32, shape, device, contiguous=False)
    if g.is_contiguous():
        return 0, 0
    # stride arithmetic, not views: a slice costs a dispatch per call
    strides, width = g.stride(), 1
    for size, stride in zip(reversed(shape[1:]), reversed(strides[1:])):
        if size != 1 and stride != width:
            raise ValueError(f"{what}: strides {strides} are neither contiguous nor rows of a "
                             f"stride")
        width *= size
    return width, strides[0]


def adam_table(params, grads, opt_state: optim.AdamState, lrs,
               rows: Rows | None = None) -> tuple[_AdamTable, list, int]:
    """The kernels' leaf table for one call, the fresh tensors it writes
    ([{name: (p', m', v')}] of the leaves, then of the rows' leaves) and the
    grid size.  Every tensor the kernels read is checked once (on the
    parameters' device, float32, the leaf's shape, contiguous, a gradient
    also as rows of a stride; the counts int32)."""
    groups = [(params, grads, opt_state.mu, opt_state.nu, lrs, 0)]
    device = params.values()[0].device
    f32 = torch.float32
    arg = kernels.check_arg
    arg("adam: count", opt_state.count, torch.int32, kernels.ONE, device)
    if rows is not None:
        n_rows = len(rows.count)
        arg("adam: the rows' count", rows.count, torch.int32, (n_rows,), device)
        arg("adam: drawn", rows.drawn, f32, (n_rows,), device)
        groups.append((rows.params, rows.grads, rows.mu, rows.nu, rows.lrs, n_rows))
    t = _AdamTable()
    sizes, outs, i = [], [], 0
    for ps, gs, ms, vs, ls, n_rows in groups:
        out = {}
        for n in ps.names():
            p = getattr(ps, n)
            shape = p.shape
            if n_rows and (len(shape) < 1 or shape[0] != n_rows):
                raise ValueError(f"adam: row leaf {n!r} of shape {tuple(shape)} does not hold "
                                 f"{n_rows} rows")
            if i == ADAM_MAX_LEAVES:
                raise ValueError(f"adam: more than {ADAM_MAX_LEAVES} leaves")
            g = getattr(gs, n)
            t.g_width[i], t.g_stride[i] = _grad_rows(f"adam: grads[{n!r}]", g, shape, device)
            t.g[i] = g.data_ptr()
            t.p[i] = arg(f"adam: params[{n!r}]", p, f32, shape, device).data_ptr()
            t.m[i] = arg(f"adam: mu[{n!r}]", getattr(ms, n), f32, shape, device).data_ptr()
            t.v[i] = arg(f"adam: nu[{n!r}]", getattr(vs, n), f32, shape, device).data_ptr()
            o = out[n] = tuple(torch.empty(shape, dtype=f32, device=device) for _ in range(3))
            t.p_out[i], t.m_out[i], t.v_out[i] = (x.data_ptr() for x in o)
            t.neg_lr[i] = -getattr(ls, n)
            t.guarded[i] = 1 if n_rows else int(n != UNGUARDED)
            t.row_width[i] = p.numel() // n_rows if n_rows else 0
            sizes.append(p.numel())
            i += 1
        outs.append(out)
    starts = chunk_plan(sizes, ADAM_MAX_LEAVES)
    t.num_leaves, t.num_chunks = len(sizes), starts[-1]
    t.chunk_start[:len(starts)] = starts
    t.numel[:len(sizes)] = sizes
    grid_cap = (torch.cuda.get_device_properties(device).multi_processor_count * BLOCKS_PER_SM
                if device.type == "cuda" else 1)
    return t, outs, max(1, min(grid_cap, t.num_chunks))
