"""Profile the port's stage-1 train step on one GPU.

    python3 -m gaussianhaircut_torch.tools.profile_stage1 [--steps 5] [--out DIR]

The step is the bench step: the bench scene (100k Gaussians, 960x544, four
views), slot capacity = point count, SH degree 3 active, BARF camera
residuals trainable (bench.py:36-99).  After warm-up, ``--steps`` steps run
under ``torch.profiler``.  Prints one JSON line: the step time (CUDA
events), the device busy time per step (the sum of kernel, copy and set
intervals on the card), the idle share, and the kernels that take the most
device time.  The Chrome trace goes to ``DIR/stage1_trace.json``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()

    from gaussianhaircut_torch.config import OptimizationConfig
    from gaussianhaircut_torch.device import resolve_device
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
    from gaussianhaircut_torch.scene.cameras import CameraBatch
    from gaussianhaircut_torch.scene.synthetic import bench_scene
    from gaussianhaircut_torch.train import stage1

    dev = resolve_device(None)
    scene = bench_scene()
    cams = scene.train_cameras
    model = gm.create_from_pcd(scene.points, scene.colors, len(scene.points), 3,
                               scene.cameras_extent, dev)
    state = stage1.init_train_state(model, len(cams), use_barf=True)
    cam_batch = CameraBatch.from_cameras(cams, dev)
    gt = stage1.GtBatch.from_cameras(cams, dev)
    kw = dict(active_sh_degree=3, width=cams[0].width, height=cams[0].height,
              raster_cfg=RasterConfig(),
              opt_cfg=OptimizationConfig(lambda_dorient=0.1),
              trainable_cameras=True, trainable_intrinsics=True, use_barf=True,
              white_background=False)

    i = 0
    for _ in range(args.warmup):
        state, _ = stage1.train_step(state, cam_batch, gt, i % len(cams), **kw)
        i += 1
    torch.cuda.synchronize()

    step_ms = []
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = stage1.train_step(state, cam_batch, gt, i % len(cams), **kw)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            i += 1
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "stage1_trace.json"))

    by_name = collections.defaultdict(float)
    busy_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] += us
            busy_us += us
    wall_ms = sum(step_ms)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "steps": args.steps,
        "step_ms_median": statistics.median(step_ms),
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "idle_share": 1.0 - busy_us / 1e3 / wall_ms if wall_ms else None,
        "num_rendered": m["num_rendered"],
        "top_kernels_ms_per_step": [[n[:120], us / 1e3 / args.steps] for n, us in top],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
