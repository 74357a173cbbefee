"""Profile the port's stage-2 and stage-3 train steps on one GPU.

    python3 -m gaussianhaircut_torch.tools.profile_strands [--steps 5] [--out DIR]

The steps run at the strand stack's full-width defaults (10,000 strands x
100 points on the synthetic scalp pool, a 256^2 texture of 64 + 65 channels,
the 32x32x64 UNet at channels 128/256/512 with its EMA, SH degree 3) over a
frozen head: the bench scene's 100k-point blob, every row labelled head,
seen by its four 960x544 cameras with random ground truth.  Stage 3 starts
from the stage-2 state after the profiled steps, with a fresh SDS prior.
After warm-up, ``--steps`` steps of each stage run under ``torch.profiler``.

Prints one JSON line per stage: the step time (CUDA events), the device busy
time per step (the sum of kernel, copy and set intervals on the card), the
idle share, ``num_rendered`` and the kernels that take the most device time.
The Chrome traces go to ``DIR/stage{2,3}_trace.json``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics

import torch


def _profile(step, steps: int, out_path: str, top: int) -> dict:
    """``step()`` -> metrics, run ``steps`` times under the profiler."""
    step_ms, metrics = [], {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step()
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
    prof.export_chrome_trace(out_path)
    by_name = collections.defaultdict(float)
    busy_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] += us
            busy_us += us
    wall_ms = sum(step_ms)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"steps": steps, "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms if wall_ms else None,
            "num_rendered": metrics["num_rendered"],
            "top_kernels_ms_per_step": [[n[:120], us / 1e3 / steps] for n, us in ranked]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()

    from gaussianhaircut_torch.config import OptimizationConfig
    from gaussianhaircut_torch.device import resolve_device
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.models import prior_io
    from gaussianhaircut_torch.models.textured_strands import (
        TexturedStrandsConfig, sample_roots, synthetic_scalp_pool)
    from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
    from gaussianhaircut_torch.scene.cameras import CameraBatch
    from gaussianhaircut_torch.scene.synthetic import bench_scene
    from gaussianhaircut_torch.train import optim, stage1, stage2, stage3

    dev = resolve_device(None)
    os.makedirs(args.out, exist_ok=True)
    scene = bench_scene()
    cams = scene.train_cameras
    model = gm.create_from_pcd(scene.points, scene.colors, len(scene.points), 3,
                               scene.cameras_extent, dev)
    model.params.label.fill_(-2.0)                 # every row is head
    head = stage2.make_head_fields(model)
    cam_batch = CameraBatch.from_cameras(cams, dev)
    gt = stage1.GtBatch.from_cameras(cams, dev)
    scfg = TexturedStrandsConfig(sh_degree=3, use_diffusion=True)
    pool = synthetic_scalp_pool(scfg.pool_size).to(dev)
    radius = torch.tensor(1e-3, device=dev)
    opt_cfg = OptimizationConfig(lambda_dmask=0.1, lambda_dorient=0.1, lambda_dsds=0.01)
    width, height = cams[0].width, cams[0].height
    view = lambda i: (gt.image[i], gt.mask[i], gt.orient_angle[i], gt.orient_conf[i], i, None,
                      radius)
    kw = dict(scfg=scfg, width=width, height=height, raster_cfg=RasterConfig(),
              opt_cfg=opt_cfg, white_background=False)
    out = {"device": torch.cuda.get_device_name(0)}

    state = stage2.init_hair_state(scfg, device=dev)
    it = [0]

    def step2():
        nonlocal state
        state, m = stage2.train_step(state, head, pool, cam_batch,
                                     *view(it[0] % len(cams)), **kw)
        it[0] += 1
        return m
    for _ in range(args.warmup):
        step2()
    torch.cuda.synchronize()
    out["stage2"] = _profile(step2, args.steps, os.path.join(args.out, "stage2_trace.json"),
                             args.top)

    roots = sample_roots(pool, scfg.num_strands, torch.Generator(device=dev).manual_seed(1))
    params, static = stage3.create_from_stage2(state.params, pool, scfg, roots)
    del state
    curves = stage3.CurvesTrainState(params, static, optim.adam_init(params), 0)
    prior = {k: m.to(dev).requires_grad_(False) for k, m in prior_io.init_prior(
        scfg, torch.Generator().manual_seed(7)).items()}
    sds_gen = torch.Generator(device=dev).manual_seed(0)

    def step3():
        nonlocal curves
        draws = stage3.draw_stage3(curves.params, scfg, sds_gen, scfg.num_guiding_strands)
        curves, m = stage3.train_step(curves, head, cam_batch, *view(it[0] % len(cams)),
                                      prior, draws, spatial_lr_scale=0.5, use_sds=True, **kw)
        it[0] += 1
        return m
    for _ in range(args.warmup):
        step3()
    torch.cuda.synchronize()
    out["stage3"] = _profile(step3, args.steps, os.path.join(args.out, "stage3_trace.json"),
                             args.top)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
