"""Per-rank runs of the multi-device stage-1 step, to hold it against a
single-device oracle.

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m gaussianhaircut_torch.tools.mesh_check --batch BATCH.npz \\
        --checkpoint STATE.npz --mesh 1x2:0 --mesh 2x1:0,1 --out DIR \\
        [--device cuda:0]

For each ``--mesh SPEC:CAMS`` (every spec of N ranks) it runs one
``dp_tp_train_step`` from the checkpoint's state on cameras CAMS (the
cameras and ground truth of ``save_batch``'s file), with the launch counts
set to 0 just before it, and writes each rank's new state
(``DIR/SPEC/rank<r>.npz``, ``stage1.checkpoint_arrays``) and record
(``rank<r>.json``: metrics, the step's kernel launches, its collectives'
calls and bytes, the backend), then times REPEATS more steps from the same
state (median step ms and collective ms per step).  The step runs at the
bench configuration's settings (SH degree 3, 32x32 tiles, lambda_dorient
0.1) and the batch's image size.

``run_jobs`` is the same per-rank body for ``torch.multiprocessing`` spawn
with a FileStore rendezvous, for the CPU tests: a "step" job as above, or a
"train" job, ``stage1.train(mesh_spec=...)`` recording each iteration's
loss and camera-row counts.  This module imports no JAX, so spawned ranks
start fast.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from gaussianhaircut_torch import kernels
from gaussianhaircut_torch.config import OptimizationConfig
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.parallel import data_parallel, tile_parallel
from gaussianhaircut_torch.parallel.mesh import init_distributed, make_mesh2d, parse_mesh_spec
from gaussianhaircut_torch.scene.cameras import CameraBatch
from gaussianhaircut_torch.train import stage1

SH_DEGREE, TILE, LAMBDA_DORIENT, REPEATS = 3, 32, 0.1, 5
BATCH_KEYS = ("colmap_transform", "fovx", "fovy", "image", "mask", "orient_angle",
              "orient_conf")


def save_batch(path: str, cam_batch: CameraBatch, gt: stage1.GtBatch) -> None:
    """The cameras and ground truth of a scene, as one npz."""
    src = {**vars(cam_batch), **vars(gt)}
    np.savez(path, **{k: src[k].cpu().numpy() for k in BATCH_KEYS})


def load_batch(d: dict, device) -> tuple[CameraBatch, stage1.GtBatch]:
    t = {k: torch.as_tensor(np.asarray(d[k]), device=device) for k in BATCH_KEYS}
    return (CameraBatch(t["colmap_transform"], t["fovx"], t["fovy"]),
            stage1.GtBatch(t["image"], t["mask"], t["orient_angle"], t["orient_conf"]))


def step_kwargs(width: int, height: int) -> dict:
    """The step's keywords at the bench settings, with the model's default
    flags (BARF, trainable cameras and intrinsics, black background)."""
    return dict(active_sh_degree=SH_DEGREE, width=width, height=height,
                raster_cfg=RasterConfig(tile_w=TILE, tile_h=TILE),
                opt_cfg=OptimizationConfig(lambda_dorient=LAMBDA_DORIENT),
                trainable_cameras=True, trainable_intrinsics=True, use_barf=True,
                white_background=False)


def one_step(mesh, state, cam_batch, gt, cams, step_kw, make_step=None):
    """One mesh step with the launch counts and the mesh's collective
    counts from 0 -> (new_state, record)."""
    make_step = make_step or tile_parallel.dp_tp_train_step
    kernels.reset_launch_counts()
    calls0, bytes0 = mesh.stats.calls, mesh.stats.bytes
    new_state, metrics = make_step(mesh, **step_kw)(state, cam_batch, gt, cams)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    rec = {"rank": mesh.rank, "mesh": f"{mesh.n_data}x{mesh.n_tile}", "cams": list(cams),
           "backend": mesh.backend, "device": str(mesh.device),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "launches": {k: kernels.launches[k] for k in ("raster_fwd", "raster_bwd")},
           "collective_calls": mesh.stats.calls - calls0,
           "bytes_per_step": mesh.stats.bytes - bytes0}
    return new_state, rec


def time_steps(mesh, state, cam_batch, gt, cams, step_kw) -> dict:
    """Median ms of REPEATS steps from the same state, and of their
    collectives (host clock around a synchronized step)."""
    step_ms, comm_ms = [], []
    step = tile_parallel.dp_tp_train_step(mesh, **step_kw)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else lambda device: None
    for _ in range(REPEATS):
        sync(mesh.device)
        c0, t0 = mesh.stats.seconds(), time.perf_counter()
        step(state, cam_batch, gt, cams)
        sync(mesh.device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        comm_ms.append((mesh.stats.seconds() - c0) * 1e3)
    return {"step_ms": statistics.median(step_ms), "step_ms_all": step_ms,
            "collective_ms": statistics.median(comm_ms)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--mesh", action="append", required=True,
                    help="SPEC:CAMS, e.g. 1x2:0 or 2x1:0,1")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    device = init_distributed(args.device)
    with np.load(args.batch) as z:
        cam_batch, gt = load_batch(dict(z), device)
    state = stage1.load_checkpoint(args.checkpoint, device)
    kw = step_kwargs(gt.image.shape[3], gt.image.shape[2])
    for entry in args.mesh:
        spec, cams = entry.split(":")
        cams = [int(c) for c in cams.split(",")]
        mesh = make_mesh2d(*parse_mesh_spec(spec), device)
        new_state, rec = one_step(mesh, state, cam_batch, gt, cams, kw)
        rec.update(time_steps(mesh, state, cam_batch, gt, cams, kw))
        out = os.path.join(args.out, spec)
        os.makedirs(out, exist_ok=True)
        np.savez(os.path.join(out, f"rank{mesh.rank}.npz"),
                 **stage1.checkpoint_arrays(new_state))
        with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(rec, f)
    dist.destroy_process_group()


def run_jobs(rank: int, store_dir: str, jobs: list, out_dir: str) -> None:
    """``torch.multiprocessing`` spawn target: job i runs on ranks [0, n)
    of its own gloo group on the CPU (a FileStore under ``store_dir``) and
    rank r writes ``out_dir/job<i>_rank<r>.pkl``.  A "step" job holds
    ``mesh``, ``cams``, ``state`` (``checkpoint_arrays``), ``batch``
    (``BATCH_KEYS``), ``step_kw`` and ``make_step`` ("dp_tp" or "dp"); a
    "train" job ``mesh`` and ``args`` / ``kwargs`` of ``stage1.train``."""
    torch.set_num_threads(1)
    for i, job in enumerate(jobs):
        n_data, n_tile = parse_mesh_spec(job["mesh"])
        world = n_data * n_tile
        if rank >= world:
            continue
        init_distributed("cpu", store=dist.FileStore(os.path.join(store_dir, f"job{i}"), world),
                         rank=rank, world_size=world,
                         timeout=datetime.timedelta(seconds=120))
        if job["kind"] == "step":
            cam_batch, gt = load_batch(job["batch"], "cpu")
            state = stage1.state_from_arrays(job["state"], "cpu")
            make_step = {"dp_tp": tile_parallel.dp_tp_train_step,
                       "dp": data_parallel.dp_train_step}[job["make_step"]]
            new_state, rec = one_step(make_mesh2d(n_data, n_tile, "cpu"), state, cam_batch,
                                      gt, job["cams"], job["step_kw"], make_step)
            result = {"state": stage1.checkpoint_arrays(new_state), "record": rec}
        else:
            history = []
            state = stage1.train(*job["args"], **job["kwargs"], mesh_spec=job["mesh"],
                                 device="cpu", progress_callback=lambda it, st, m: history.append(
                                     (it, float(m["total"]), st.cam_opt.count.numpy().copy())))
            result = {"state": stage1.checkpoint_arrays(state), "history": history}
        with open(os.path.join(out_dir, f"job{i}_rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
