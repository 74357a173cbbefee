"""The process mesh of the multi-device stage-1 step: torch's counterpart of
the JAX package's ``jax.sharding.Mesh`` over axes ``("data", "tile")``.

One process per rank, as ``torch.distributed.run`` starts them:

    python -m torch.distributed.run --nproc_per_node=N \\
        -m gaussianhaircut_torch.cli.train_gaussians --mesh DxT ...

Rank ``r`` sits at ``(r // n_tile, r % n_tile)`` (the JAX package reshapes
its device list the same way, ``tile_parallel.py:40-46``).  Every rank
creates every group, in the same order: one ``data`` group per tile index
(the ranks that hold the same rows of different cameras) and one ``tile``
group per data index (the ranks that render one camera).

Device and backend, decided here and printed once by rank 0:
- ``--device cpu``: every rank on the CPU, gloo;
- no device or ``cuda``: rank ``LOCAL_RANK`` takes ``cuda:LOCAL_RANK``, each
  rank a card of its own, NCCL (more ranks than cards raises);
- ``cuda:K`` with several ranks on the host: the ranks share card K, gloo
  (NCCL refuses two ranks on one card).
A 1x1 mesh needs no launcher and no process group; a larger one without a
launcher raises with the launch command.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from gaussianhaircut_torch.device import resolve_device

LAUNCH = ("python -m torch.distributed.run --nproc_per_node={n} "
          "-m gaussianhaircut_torch.cli.train_gaussians --mesh {spec} ...")


@dataclasses.dataclass
class CommStats:
    """What the collectives of one mesh moved: calls, bytes handed to them,
    and their spans (CUDA events on the card, the host clock on the CPU),
    summed lazily by ``seconds()``."""
    calls: int = 0
    bytes: int = 0
    _seconds: float = 0.0
    _pending: list = dataclasses.field(default_factory=list)

    def record(self, nbytes: int, span) -> None:
        """One collective of ``nbytes``; ``span`` is its seconds or its
        (start, end) CUDA events."""
        self.calls += 1
        self.bytes += nbytes
        if isinstance(span, tuple):
            self._pending.append(span)
            if len(self._pending) > 256:
                self.seconds()
        else:
            self._seconds += span

    def seconds(self) -> float:
        """Seconds spent in collectives so far (waits for the card)."""
        for start, end in self._pending:
            end.synchronize()
            self._seconds += start.elapsed_time(end) / 1e3
        self._pending.clear()
        return self._seconds


@dataclasses.dataclass
class Mesh:
    n_data: int
    n_tile: int
    rank: int
    device: torch.device
    backend: str | None                  # None: a 1x1 mesh without a process group
    data_group: object = None            # the ranks of my tile index
    tile_group: object = None            # the ranks of my data index
    stats: CommStats = dataclasses.field(default_factory=CommStats)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_tile

    @property
    def tile_index(self) -> int:
        return self.rank % self.n_tile

    def group(self, axis: str):
        """The process group of ``axis``: "data", "tile" or "world"."""
        return {"data": self.data_group, "tile": self.tile_group,
                "world": dist.group.WORLD if self.backend else None}[axis]


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """ "DATAxTILE" -> (n_data, n_tile)."""
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"mesh {spec!r}: expected DATAxTILE, e.g. 4x2")
    return int(parts[0]), int(parts[1])


def process_rank() -> int:
    """This process's rank: the process group's, else the launcher's."""
    return dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", "0"))


def require_launcher(n_data: int, n_tile: int) -> None:
    """A mesh of more than one rank needs a process per rank."""
    n = n_data * n_tile
    if n > 1 and not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            f"--mesh {n_data}x{n_tile} runs one process per rank; launch {n} of them: "
            + LAUNCH.format(n=n, spec=f"{n_data}x{n_tile}"))


def rank_device(device=None) -> tuple[torch.device, str]:
    """This rank's device and the backend every rank takes (module doc)."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev, "gloo"
    if dev.index is not None:
        return dev, "gloo" if local_world > 1 else "nccl"
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own ({torch.cuda.device_count()} "
            "cards); pass --device cuda:0 to share one card (gloo)")
    return torch.device("cuda", local_rank), "nccl"


def init_distributed(device=None, *, store=None, rank: int | None = None,
                     world_size: int | None = None,
                     timeout: datetime.timedelta | None = None) -> torch.device:
    """Start the default process group for this rank -> its device.  The
    launcher's environment gives the rank and world size unless ``store``,
    ``rank`` and ``world_size`` are passed (a FileStore, say)."""
    dev, backend = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"timeout": timeout} if timeout is not None else {}
    if store is None:
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                **kw)
    if dist.get_rank() == 0:
        shared = backend == "gloo" and dev.type == "cuda"
        print(f"process group: {dist.get_world_size()} ranks, backend {backend}"
              + (f", the ranks share {dev}" if shared else f", on {dev.type}"), flush=True)
    return dev


def make_mesh2d(n_data: int, n_tile: int, device=None) -> Mesh:
    """(data, tile) mesh over this job's ranks: cameras over ``data``, tile
    rows over ``tile``.  Starts the process group from the launcher's
    environment unless one is running."""
    n = n_data * n_tile
    if not dist.is_initialized():
        if n == 1 and int(os.environ.get("WORLD_SIZE", "1")) == 1:
            return Mesh(1, 1, 0, resolve_device(device), None)
        require_launcher(n_data, n_tile)
        device = init_distributed(device)
    elif device is None:
        device = rank_device()[0]
    else:
        device = resolve_device(device)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"mesh {n_data}x{n_tile} needs {n} ranks, the job has {world}")
    rank = dist.get_rank()
    data_group = tile_group = None
    for t in range(n_tile):
        g = dist.new_group([d * n_tile + t for d in range(n_data)])
        if rank % n_tile == t:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_tile + t for t in range(n_tile)])
        if rank // n_tile == d:
            tile_group = g
    return Mesh(n_data, n_tile, rank, torch.device(device), dist.get_backend(),
                data_group, tile_group)


def make_camera_mesh(n: int, device=None) -> Mesh:
    """The 1-D camera mesh of ``dp_train_step``: ``n`` x 1."""
    return make_mesh2d(n, 1, device)
