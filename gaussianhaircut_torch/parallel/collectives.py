"""Every collective of the multi-device stage-1 step, in one place: sums and
maxima over the ``data`` axis, the ``tile`` axis or the whole world, the
row gather of the tile-row windows and a gather of small records.

Explicit collectives, not ``DistributedDataParallel``: DDP averages over the
whole world, which gives 1/(n_data * n_tile) where the JAX package takes
``psum`` over ``tile`` then ``pmean`` over ``data``, and it knows nothing of
the camera rows or the densify statistics.  Callers flatten what they reduce
into one buffer per axis and step (``flatten`` / ``unflatten``).

gloo takes CUDA tensors in every collective used here (all_reduce, with
sum and with max on int64, and all_gather: checked on the H100
by ``chip_smoke.py``'s mesh phase, which fails if one refuses them), so
ranks that share a card hand gloo their tensors as they are.  On a mesh
without a process group (1x1 without a launcher) every collective is the
identity.

Each call adds its bytes and its span to the mesh's ``CommStats``: CUDA
events around it on the card (summed when read, no sync in the step), the
host clock on the CPU.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from gaussianhaircut_torch.parallel.mesh import Mesh

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _run(mesh: Mesh, tensor: torch.Tensor, fn) -> None:
    """``fn()``, a collective writing ``tensor``, counted in ``mesh.stats``."""
    if tensor.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    fn()
    if tensor.is_cuda:
        end.record()
    mesh.stats.record(tensor.numel() * tensor.element_size(),
                      (start, end) if tensor.is_cuda else time.perf_counter() - t0)


def all_reduce(mesh: Mesh, tensor: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
    """In-place sum or max of ``tensor`` over ``axis`` ("data", "tile" or
    "world"); every rank of the axis gets the same bits."""
    group = mesh.group(axis)
    if group is not None:
        _run(mesh, tensor, lambda: dist.all_reduce(tensor, op=_OPS[op], group=group))
    return tensor


def all_gather(mesh: Mesh, tensor: torch.Tensor, axis: str) -> torch.Tensor:
    """[n, *shape]: ``tensor`` of every rank of ``axis``, in rank order."""
    group = mesh.group(axis)
    if group is None:
        return tensor[None].clone()
    n = dist.get_world_size(group)
    out = torch.empty((n,) + tuple(tensor.shape), dtype=tensor.dtype, device=tensor.device)
    # all_gather writes into the list's tensors, views of the buffer
    _run(mesh, out, lambda: dist.all_gather(list(out.unbind(0)), tensor.contiguous(),
                                            group=group))
    return out


class _GatherRows(torch.autograd.Function):
    """[C, rows, W] windows of the tile ranks -> [C, n_tile * rows, W].

    The loss is computed replicated, identically, on every tile rank, so
    every rank's cotangent of the gathered image is the same and a rank's
    window gets its own rows of it: no reduction and no 1/n_tile.  (The JAX
    package divides the loss by n_tile and lets ``psum_scatter`` sum the
    n_tile equal cotangents, ``tile_parallel.py:92-106``: the same value.)"""

    @staticmethod
    def forward(ctx, window, mesh):
        ctx.rows, ctx.index = window.shape[1], mesh.tile_index
        rows = all_gather(mesh, window, "tile")               # [T, C, rows, W]
        return rows.transpose(0, 1).reshape(window.shape[0], -1, window.shape[2])

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.index * ctx.rows
        return g[:, r0:r0 + ctx.rows].contiguous(), None


def gather_rows(mesh: Mesh, window: torch.Tensor) -> torch.Tensor:
    """The full-height image [C, n_tile * rows, W] from every tile rank's
    window [C, rows, W] (differentiable, see ``_GatherRows``)."""
    return _GatherRows.apply(window, mesh)


def flatten(tensors) -> torch.Tensor:
    """One float32 buffer of ``tensors``, in order (``unflatten`` undoes it)."""
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def unflatten(flat: torch.Tensor, like) -> list:
    """Views of ``flat`` shaped as each tensor of ``like``."""
    sizes = [t.numel() for t in like]
    return [p.view(t.shape) for p, t in zip(torch.split(flat, sizes), like)]
