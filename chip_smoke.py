#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases env,build,kernel_fwd,kernel_bwd,train]

Drives the port's main path, the stage-1 trainer, on the bench scene
(seeded synthetic point cloud, 100k Gaussians, 960x544, SH degree 3, four
views, BARF camera residuals trainable, 32x32 tiles, chunk 256):

1. env        -- requires CUDA; prints the card's name and power limit;
2. build      -- compiles the CUDA kernels from the checkout's sources;
3. kernel_fwd -- the compositing forward kernel against its plain PyTorch
                 version on camera 0 of the bench scene;
4. kernel_bwd -- the compositing backward kernel against its plain version,
                 and two kernel runs bit for bit;
5. train      -- the port's ``train()`` for 50 iterations with densify and
                 one opacity reset; launch counts must equal the steps.

Each phase prints one JSON line; then one line lists every kernel, then the
card's name and power limit, and the last line is the device record.  Any
failure raises: the script exits non-zero without the last line.  With
``--phases`` naming only some phases, the last line is ``{"ok": "partial",
...}`` and no kernels line is printed.  Times are CUDA-event medians on this
card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "kernel_fwd", "kernel_bwd", "train")

# bench configuration (bench.py:36-99)
P, WIDTH, HEIGHT, N_VIEWS, SEED = 100_000, 960, 544, 4, 0
REPS = 20          # timed repetitions of every CUDA-event timing

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (pixel, instance) pair, counted from the kernels'
# source: a visited pair costs the exponent (dx, dy and the quadratic form,
# 11), exp (1), op * e (1), the clamp and two compares (3) = 16; a blended
# pair adds 1 - alpha, T (1 - alpha), alpha T and 10 colour FMAs (23).  The
# backward's blended pair adds u (20), prefix / suffix / d alpha (7), the six
# geometry terms (14), ten colour terms (10) and the 16-term pixel
# reduction (16) = 67 more, 90 in all.
OPS_VISIT = 16
OPS_BLEND_FWD = 23
OPS_BLEND_BWD = 90
# gradient rows of the backward's dpay [TC, 16, CH], by what they hold
DPAY_ROWS = {"mean": range(0, 2), "conic": range(2, 5), "opacity": range(5, 6),
             "colour": range(6, 16)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def binned_inputs(torch, params, alive, sh_degree, scene, cam_idx, cfg, dev):
    """Render inputs of one camera, preprocessed and binned (no autograd)."""
    from gaussianhaircut_torch.ops.rasterize import common as C
    from gaussianhaircut_torch.ops.rasterize.api import ndc_xy_to_pixel
    from gaussianhaircut_torch.render.renderer import (
        fields_from_params, prepare_raster_inputs)
    from gaussianhaircut_torch.scene.cameras import CameraBatch, camera_geom
    with torch.no_grad():
        cb = CameraBatch.from_cameras(scene.train_cameras, dev)
        cam = camera_geom(cb.colmap_transform[cam_idx], cb.fovx[cam_idx],
                          cb.fovy[cam_idx], WIDTH, HEIGHT, None)
        ndc, conic, colors, opacity, depth, valid = prepare_raster_inputs(
            fields_from_params(params, alive), sh_degree, cam)
        mean_pix = ndc_xy_to_pixel(ndc, WIDTH, HEIGHT)

        def binning():
            pre = C.preprocess(mean_pix, conic, depth, valid, WIDTH, HEIGHT, cfg,
                               opacity=opacity)
            return C.bin_instances(pre, mean_pix, conic, opacity, colors, depth,
                                   WIDTH, HEIGHT, cfg)
        return binning(), binning


def seeded_cotangent(torch, cfg, dev):
    from gaussianhaircut_torch.ops.rasterize import common as C
    from gaussianhaircut_torch.render.renderer import default_background
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    g_img = torch.randn((C.NUM_CHANNELS, HEIGHT, WIDTH), generator=gen, device=dev)
    g_t = torch.randn((HEIGHT, WIDTH), generator=gen, device=dev)
    return C.disassemble_cotangent(g_img, g_t, default_background(False, dev),
                                   WIDTH, HEIGHT, cfg)


def hold_dpay(got, plain, rtol: float = 1e-3, atol_frac: float = 1e-4) -> dict:
    """Holds the backward kernel's dpay against its plain version row by
    row: |got - plain| <= atol_frac * max|plain row| + rtol * |plain|.  One
    scale for all rows would let the conic rows, larger than the others by
    orders of magnitude, hide a wrong mean, opacity or colour row.  Returns
    each row's max |plain| and max error, by row group."""
    scale = plain.abs().amax(dim=(0, 2))
    err = (got - plain).abs()
    excess = (err - (atol_frac * scale[None, :, None] + rtol * plain.abs())).amax(dim=(0, 2))
    err = err.amax(dim=(0, 2))
    for row in range(plain.shape[1]):
        require(float(scale[row]) > 0,
                f"backward: plain row {row} is all zero, so the check cannot fail there")
        require(float(excess[row]) <= 0,
                f"backward kernel: row {row} beyond rtol {rtol} / atol {atol_frac} x "
                f"max|row| (max|row| {float(scale[row])}, max err {float(err[row])})")
    return {group: {"max_abs_dpay": scale[list(rows)].tolist(),
                    "max_abs_err": err[list(rows)].tolist()}
            for group, rows in DPAY_ROWS.items()}


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    for ph in phases:
        require(ph in PHASES, f"unknown phase {ph!r}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from gaussianhaircut_torch.ops.rasterize import common as C
        from gaussianhaircut_torch.ops.rasterize import cuda_core, plain_core
        from gaussianhaircut_torch.ops.rasterize.api import segment_sum
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing next to this "
              f"script ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    cfg = C.RasterConfig(tile_w=32, tile_h=32, chunk=256)
    kernels = {
        "raster_fwd": {"name": "raster_fwd", "route": "cuda",
                       "source": "gaussianhaircut_torch/csrc/raster_fwd.cu",
                       "replaces": "gaussianhaircut_tpu/ops/rasterize/pallas_core.py:589",
                       "library_ms": None},
        "raster_bwd": {"name": "raster_bwd", "route": "cuda",
                       "source": "gaussianhaircut_torch/csrc/raster_bwd.cu",
                       "replaces": "gaussianhaircut_tpu/ops/rasterize/pallas_core.py:938",
                       "library_ms": None},
    }

    if "env" in phases:
        emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "tf32": [torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32]})

    t0 = time.perf_counter()
    logs = cuda_core.build(verbose=True)
    build_s = time.perf_counter() - t0
    if "build" in phases:
        ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "seconds": round(build_s, 3), "ptxas": ptxas})

    from gaussianhaircut_torch.scene.synthetic import bench_scene
    scene = bench_scene(P, WIDTH, HEIGHT, N_VIEWS, SEED)
    fwd_tile_buf = None
    binned = None
    if "kernel_fwd" in phases or "kernel_bwd" in phases:
        from gaussianhaircut_torch.models import gaussian_model as gm
        model = gm.create_from_pcd(scene.points, scene.colors, P, 3, 1.0, dev)
        binned, _ = binned_inputs(torch, model.params, model.aux.alive, 3, scene,
                                  0, cfg, dev)
        lay = (binned.payload, binned.chunk_start, binned.nchunks)
        used_chunks = int(binned.nchunks.sum())
        in_bytes = used_chunks * 16 * cfg.chunk * 4 + 2 * binned.num_tiles * 4
        buf_bytes = binned.num_tiles * cfg.tile_pix * C.PAD_CHANNELS * 4
        stats = {}
        plain_buf = plain_core.raster_fwd_plain(*lay, WIDTH, HEIGHT, cfg, stats=stats)
        fwd_tile_buf = cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg)
        torch.cuda.synchronize()

    if "kernel_fwd" in phases:
        err = (fwd_tile_buf - plain_buf).abs().amax(dim=(0, 1))
        err_col = float(torch.cat([err[:9], err[15:16]]).max())
        err_depth = float(err[9])
        done_mismatch = int((fwd_tile_buf[..., C.CH_DONE] != plain_buf[..., C.CH_DONE]).sum())
        require(bool(torch.isfinite(fwd_tile_buf).all()), "forward kernel: non-finite output")
        require(err_col <= 1e-4, f"forward kernel: colour/T error {err_col} > 1e-4")
        require(err_depth <= 1e-3, f"forward kernel: depth error {err_depth} > 1e-3")
        ms = cuda_ms(torch, lambda: cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg), REPS)
        plain_ms = cuda_ms(torch, lambda: plain_core.raster_fwd_plain(
            *lay, WIDTH, HEIGHT, cfg), REPS)
        ops = stats["visited"] * OPS_VISIT + stats["contrib"] * OPS_BLEND_FWD
        b_ms, b_by = bound_ms(in_bytes + buf_bytes, ops)
        kernels["raster_fwd"].update(max_abs_err=max(err_col, err_depth), ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "kernel_fwd", "num_rendered": binned.num_rendered,
              "tiles": binned.num_tiles, "chunks_used": used_chunks,
              "pairs_visited": stats["visited"], "pairs_blended": stats["contrib"],
              "max_err_colour_T": err_col, "max_err_depth": err_depth,
              "done_latch_mismatches": done_mismatch, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by,
              "launches": cuda_core.launches["raster_fwd"]})

    if "kernel_bwd" in phases:
        gbuf = seeded_cotangent(torch, cfg, dev)
        bargs = (*lay, fwd_tile_buf, gbuf, WIDTH, HEIGHT, cfg)
        d1 = cuda_core.raster_bwd(*bargs)
        d2 = cuda_core.raster_bwd(*bargs)
        plain = plain_core.raster_bwd_plain(*bargs)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(d1).all()), "backward kernel: non-finite output")
        require(torch.equal(d1, d2), "backward kernel: two runs differ")
        require(torch.equal(segment_sum(d1, binned), segment_sum(d2, binned)),
                "segment reduction: two runs differ")
        rows = hold_dpay(d1, plain)
        max_err = float((d1 - plain).abs().max())
        ms = cuda_ms(torch, lambda: cuda_core.raster_bwd(*bargs), REPS)
        plain_ms = cuda_ms(torch, lambda: plain_core.raster_bwd_plain(*bargs), REPS)
        ops = stats["visited"] * OPS_VISIT + stats["contrib"] * OPS_BLEND_BWD
        nbytes = in_bytes + 2 * buf_bytes + used_chunks * C.GRAD_ROWS * cfg.chunk * 4
        b_ms, b_by = bound_ms(nbytes, ops)
        kernels["raster_bwd"].update(max_abs_err=max_err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "kernel_bwd", "rows": rows, "max_abs_err": max_err,
              "bit_identical": True, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by})
        del plain, d1, d2

    if "train" in phases:
        emit(train_phase(torch, scene, cfg, dev, kernels))

    complete = all(ph in phases for ph in PHASES)
    if complete:
        for k in kernels.values():
            missing = {"launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by"} - set(k)
            require(not missing, f"{k['name']}: no {sorted(missing)}")
        emit({"kernels": list(kernels.values())})
    print(nvidia_smi())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    # a run of some phases only is no smoke run: its last line says so
    emit({"ok": True, "device": device} if complete
         else {"ok": "partial", "phases": phases, "device": device})
    return 0


def small_input_check(torch, cfg, dev):
    """The whole render path on the card (binning, both kernels, the
    segment reduction inside rasterize's autograd.Function) against the
    plain path on the CPU, on a small scene: image and parameter gradients
    of a seeded weighted sum of the render."""
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.render.renderer import default_background, render
    from gaussianhaircut_torch.scene.cameras import CameraBatch, camera_geom
    from gaussianhaircut_torch.scene.synthetic import bench_scene
    small = bench_scene(2000, 128, 96, N_VIEWS, SEED + 2)
    weights = torch.from_numpy(np.random.default_rng(SEED + 3).normal(
        size=(10, 96, 128)).astype(np.float32))
    outs = {}
    for d in (dev, torch.device("cpu")):
        model = gm.create_from_pcd(small.points, small.colors, 2048, 3, 1.0, d)
        params = model.params.map(lambda t: t.detach().requires_grad_())
        cb = CameraBatch.from_cameras(small.train_cameras, d)
        cam = camera_geom(cb.colmap_transform[1], cb.fovx[1], cb.fovy[1], 128, 96, None)
        out = render(params, model.aux.alive, 3, cam, default_background(False, d), cfg)
        loss = torch.sum(out["render10"] * weights.to(d))
        grads = torch.autograd.grad(loss, params.values())
        outs[d.type] = [out["render10"].detach().cpu()] + [g.cpu() for g in grads]
    errs = {}
    for name, a, b in zip(("render",) + tuple(gm.GaussianParams.names()),
                          outs["cuda"], outs["cpu"]):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        ok = bool(((a - b).abs() <= 1e-4 * max(scale, 1.0) + 1e-3 * b.abs()).all())
        require(ok, f"small input: {name} differs (max err {err}, max {scale})")
        errs[name] = err
    return errs


def train_phase(torch, scene, cfg, dev, kernels):
    """train() at the bench configuration with densify and one opacity
    reset; it/s from four 10-step windows; the per-step split from the
    components timed alone at the final state's shapes."""
    from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussianhaircut_torch.ops.rasterize import cuda_core
    from gaussianhaircut_torch.ops.rasterize.api import segment_sum
    from gaussianhaircut_torch.train import stage1

    iters, window = 50, 10
    opt_cfg = OptimizationConfig(iterations=iters, lambda_dorient=0.1,
                                 densify_from_iter=10, densification_interval=10,
                                 opacity_reset_interval=30)
    model_cfg = ModelConfig(sh_degree=3, use_barf=True, trainable_cameras=True,
                            trainable_intrinsics=True)
    pipe_cfg = PipelineConfig(tile=32)
    totals, oks, alive, marks = [], [], {}, {}

    def progress(it, st, m):
        totals.append(m["total"])
        oks.append(m["grads_ok"])
        if it % window == 0 or it % window == window - 1:
            alive[it] = st.model.num_alive()      # syncs
        if it % window == 0:
            torch.cuda.synchronize()
            marks[it] = time.perf_counter()

    small_errs = small_input_check(torch, cfg, dev)
    cuda_core.reset_launch_counts()
    state = stage1.train(model_cfg, opt_cfg, pipe_cfg, scene, device=dev,
                         progress_callback=progress)
    torch.cuda.synchronize()
    launches = dict(cuda_core.launches)
    totals = torch.stack(totals).cpu().numpy()
    require(bool(np.isfinite(totals).all()), "train: non-finite loss")
    require(bool(torch.stack(oks).all()), "train: a step had non-finite gradients")
    for name in ("raster_fwd", "raster_bwd"):
        require(launches[name] == iters,
                f"train: {name} launched {launches[name]} times in {iters} steps")
        kernels[name]["launches"] = launches[name]
    densified = [it for it in range(2 * window, iters + 1, window)]
    require(any(alive[it] != alive[it - 1] for it in densified),
            f"train: num_alive never changed at densify ({alive})")
    rates = [window / (marks[b] - marks[a])
             for a, b in zip(sorted(marks)[:-1], sorted(marks)[1:])]
    its = statistics.median(rates)
    step_ms = 1e3 / its

    # per-step split at the final state's shapes (camera 0, SH degree 0 as
    # the trainer uses before iteration 1000)
    binned, binning = binned_inputs(torch, state.model.params, state.model.aux.alive,
                                    0, scene, 0, cfg, dev)
    lay = (binned.payload, binned.chunk_start, binned.nchunks)
    tile_buf = cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg)
    gbuf = seeded_cotangent(torch, cfg, dev)
    dpay = cuda_core.raster_bwd(*lay, tile_buf, gbuf, WIDTH, HEIGHT, cfg)
    split = {
        "binning_ms": cuda_ms(torch, binning, REPS),
        "forward_kernel_ms": cuda_ms(torch, lambda: cuda_core.raster_fwd(
            *lay, WIDTH, HEIGHT, cfg), REPS),
        "backward_kernel_ms": cuda_ms(torch, lambda: cuda_core.raster_bwd(
            *lay, tile_buf, gbuf, WIDTH, HEIGHT, cfg), REPS),
        "segment_reduction_ms": cuda_ms(torch, lambda: segment_sum(dpay, binned), REPS),
    }
    split["rest_ms"] = step_ms - sum(split.values())
    return {"phase": "train", "iterations": iters, "it_per_s_median": its,
            "it_per_s_windows": rates, "it_per_s_min": min(rates),
            "it_per_s_max": max(rates), "step_ms": step_ms, "split": split,
            "small_input_max_err": small_errs,
            "loss_first": float(totals[0]), "loss_last": float(totals[-1]),
            "num_alive": {str(k): v for k, v in sorted(alive.items())},
            "num_rendered_final": binned.num_rendered, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


if __name__ == "__main__":
    sys.exit(main())
