#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases env,build,kernel_fwd,kernel_probe,kernel_bwd,train,viewer,
                                    cli,mesh,batched,video,strands,kernel_strands,pipeline,masks,
                                    tools,quality,optim_tail,precompute]

Drives the port's main paths, the stage-1 trainer and its CLIs, the
multi-device step on one card, the batched-camera step, the live viewer, the video, the strand
stack's CLIs, the whole reconstruction pipeline, the mask fallback and the converter and
record tools, on the bench
scene (seeded synthetic point cloud, 100k Gaussians, 960x544, SH degree 3,
four views, BARF camera residuals trainable, 32x32 tiles, chunk 256):

1. env          -- requires CUDA; prints the card's name and power limit;
2. build        -- compiles the CUDA kernels from the checkout's sources;
3. kernel_fwd   -- the compositing forward kernel against its plain PyTorch
                   version on camera 0 of the bench scene (bit for bit), and
                   the card's per-warp cull masks against their plain mirror;
4. kernel_probe -- the forward's fixed-cost probe against its plain version
                   on the same layout, then the profiling path
                   (``tools/profile_fixed.measure``): forward, probe and
                   grid-only probe timed in turns, and the forward's split
                   into fixed cost and pair maths;
5. kernel_bwd   -- the compositing backward kernel against its plain version,
                   and two kernel runs bit for bit;
6. train        -- the port's ``train()`` for 50 iterations with densify and
                   one opacity reset; launch counts must equal the steps;
7. viewer       -- the SIBR live viewer (``render/network_gui``) during a
                   20-iteration ``train()``: a loopback client sends one
                   request per iteration, three of them 960x544 cameras
                   (the last with keep_alive, which holds the trainer for
                   one more request); every reply equals ``render()`` of
                   its camera on the state it was rendered from, the
                   training finishes, one forward launch per image and one
                   forward and backward per step; round trip and reply ms;
8. cli          -- the bench scene written to disk in the COLMAP layout,
                   ``cli.train_gaussians`` for 60 iterations (evaluation,
                   PLY, checkpoint and camera pickles), a resume from the
                   iteration-30 checkpoint to 40, and ``cli.render_gaussians``
                   on the result; launch counts must equal the steps plus
                   the renders;
9. mesh         -- the multi-device step (``parallel/``) on the cli phase's
                   scene and iteration-30 checkpoint, every rank on this
                   card: (a) a 1x1 mesh under NCCL in this process, one
                   step equal to ``train_step`` bit for bit (and
                   ``train_step`` timed), and the 1x2, 1x4 and 1x8 row
                   windows of camera 0 equal to its render's rows bit for
                   bit (the kernels' grid origin at row0 > 0); (b) two ranks
                   under gloo started by torch.distributed.run
                   (``tools/mesh_check``): a 1x2 step (windows of 288
                   rows) within tests/test_parallel.py's tolerances of the
                   single-card step and a 2x1 step within them of both
                   cameras' gradients averaged here by hand; (c)
                   ``train_gaussians --mesh 2x2`` for 30 iterations with one
                   densification, four ranks, started on an empty kernel
                   build directory: finite losses, one forward and one
                   backward launch per rank and step (and rank 0's five
                   evaluation renders), equal state hashes, and rank 0's
                   files load back in ``render_gaussians``.  Every
                   collection of ranks is bit-identical.  Also records
                   whether NCCL takes two ranks on one card, and requires
                   that gloo takes CUDA tensors in every collective
                   ``parallel/collectives.py`` uses; step ms, collective
                   ms and bytes per step per rank;
10. batched     -- the batched-camera step on the cli phase's scene and
                   iteration-30 checkpoint: (a) ``rasterize_batched`` of all
                   four views equal to four ``rasterize`` calls bit for bit
                   (render, final_T, radii, visibility); (b) both kernels on
                   the four views' virtual grid of 4 x 510 tiles against
                   their plain versions (the forward bit for bit, the warp
                   masks equal, the backward twice bit-identical) and the
                   backward row by row at two views; (c) the parameter
                   gradients of a seeded cotangent through one batched
                   render against the sum of four single renders'
                   (BATCH_GRAD_TOL; whether bit-equal is printed); (d)
                   ``train_step_batched`` at B=1 equal to ``train_step`` bit
                   for bit, and at B=2 within tests/test_parallel.py's
                   tolerances of two ``step_grads`` averaged here by hand;
                   (e) ``train(camera_batch=2)`` for 20 iterations through
                   one densification: one launch of each kernel per step,
                   finite losses; (f) ms per step, cameras/s, launches,
                   ``num_rendered`` and peak memory at B = 1, 2 and 4
                   (median of BATCH_REPS synchronized steps from the same
                   state; ``train_step`` timed beside them), and the two
                   kernels' ms on the four-view grid;
11. video        -- ``cli.render_video`` on the cli phase's model for 24
                   frames: exactly 24 forward launches, frame 0 equal to the
                   plain forward's render of its camera (the tile buffer bit
                   for bit, the PNG byte for byte), the AVI's index read
                   back to the frames' PNG bytes; frames/s and peak memory;
12. strands     -- the strand stack on the bench scene written to disk:
                   ``cli.train_gaussians`` for 20 iterations (the head PLY
                   and camera pickles), ``cli.train_latent_strands`` at the
                   full-width defaults (10,000 strands x 100 points, texture
                   256, UNet 128/256/512 at 32x32) with ``--use_diffusion``
                   for 40 iterations, ``cli.train_strands`` from its
                   checkpoint with ``--use_sds`` for 40, ``cli.export_curves``;
                   each step launches each compositing kernel once (and in
                   stage 2 each kernel of the fused optimizer tail once:
                   ``kernels.launches``), the losses are finite,
                   the checkpoints load back and the exported [10000, 100, 3]
                   strands are finite; per stage
                   it/s, instances (the hair rows' share), chunks, the
                   largest tile and peak memory;
13. kernel_strands -- at the final stage-2 layout of ``strands`` (camera 0,
                   the head and 990k strand Gaussians): the forward bit for
                   bit, the backward row by row (two runs bit-identical),
                   the probe and the card's warp masks against their plain
                   versions, with the kernels' times and bounds;
14. pipeline    -- the reconstruction pipeline from a scene directory:
                   8 views at 1920x1088 rendered from the strand scene of
                   ``strands`` (images, hair / face / body masks), COLMAP
                   text with the 100k points, a closed sphere head of
                   9,936 faces and its scalp cap as the FLAME fit;
                   ``cli.run_pipeline`` with 30 / 20 / 20 iterations and
                   the strand defaults (filter, resize, orientation maps,
                   colmap_to_h3ds, stage 1, crop and head filter, synthetic
                   GT, stages 2 and 3, export_curves, render_strands), then
                   ``cli.export_strands`` at 30,000 strands and
                   ``cli.metrics`` on the renders against images_2; every
                   stage's files load back, one forward launch per rendered
                   view and one forward and backward per step, an
                   orientation map and winding numbers on the card against
                   the CPU; per-stage seconds, orientation ms per view,
                   winding-number terms per second, LPIPS ms per pair,
                   render_strands s per view, export_strands s and peak
                   memory; then the scalp stage (``preprocessing.scalp.
                   extract_scalp``) on that scene's sphere head, the masks
                   the resize stage wrote and the stage-1 camera matrices:
                   one view's pixel-to-face map equal to the plain numpy
                   loop, a non-empty scalp cut from the head, a non-empty
                   UV mask, and its seconds;
15. masks       -- ``cli.calc_masks`` (the GrabCut fallback) on two of that
                   scene's raw 1920x1088 views: non-empty hair, face and
                   body masks, hair and face nearly disjoint; seconds per
                   view, split into the min cuts and the rest;
16. tools       -- the five tools of ``gaussianhaircut_torch/tools`` that write the
                   pretrained weights and the records, on the card: (a) the three
                   converters' ``--selftest``; (b) ``convert_lpips`` from a full-size
                   torchvision-layout VGG16 state dict (classifier included, named by
                   its digest) and LPIPS heads written from ``synthesize_weights(0)``:
                   the npz equal to that blob key for key, ``--verify`` passing, and
                   the converted LPIPS on two 960x544 renders of the strand layout
                   (cameras 0 and 1) within LPIPS_CARD_RTOL of the CPU module's; (c)
                   ``convert_neuralhaircut_ckpt`` on the upstream twin of
                   tests/test_prior_convert_e2e.py at length 100 with a twin
                   denoiser distilled into the default UNet, then ``load_prior``, the
                   stage-2 warm start (the decoder equal to the prior's) and one
                   full-width stage-2 step with the converted denoiser frozen: one
                   launch of each compositing kernel; (d) ``convert_hyperiqa`` on a
                   hyperIQA twin over the frames of (f), its npz scoring every frame
                   through ``CnnScorer`` on the card and on the CPU alike; (e)
                   ``s3_lr_probe`` on the strands phase's stage-2 checkpoint with
                   ``--iters 20 --lrs 0.2,0.02 --sh_degree 3``: finite results, the
                   ground truth, evaluations and steps' launches; (f)
                   ``pipeline_e2e_run.build_scene`` at its defaults (24 views at 1024
                   px, 10,000 teacher strands of 100): 24 forward launches and the
                   scene's files; seconds, launches and peak memory of each part;
17. quality     -- the quality harnesses on the card: the strand gate of
                   tests/test_quality_gate_strands.py at its configuration
                   (96 px, 10 + 3 views, 384 strands x 16, texture 64, 500
                   stage-2 iterations, a 120-step distilled prior, 300
                   stage-3 iterations with SDS) and floors (stage-2 test
                   PSNR >= 22.0 dB, stage 3 >= 24.0 dB, stage-3 chamfer <=
                   1.5x its init); ``tools.quality_run`` at
                   QUALITY_r05.json's widths (teacher 50,000, 512 px, 20 + 4
                   views) for 3,000 iterations, its test PSNR beside the JAX
                   record's 3,000-iteration point; ``train.prior.
                   distill_strand_prior`` at the full-width defaults (10,000 x
                   100 teacher strands, diffusion input 32, UNet 128/256/512)
                   for 100 steps, its loss falling on 8 fixed draws, ms per
                   step, and the prior saved and loaded back through
                   ``models.prior_io``; one forward
                   launch per rendered view and one forward and backward per
                   training step;
18. optim_tail  -- stage 2's fused optimizer tail (``train/optim_tail.py``,
                   ``csrc/optim_tail.cu``) against its plain version (the
                   per-leaf composition, on the card) on the strand stage's
                   194 leaf shapes at the full-width defaults, with the
                   EMA on the UNet's leaves, for three steps: the clip loose,
                   the clip binding, a NaN in one leaf (parameters, moments
                   and count kept, the EMA moved); parameters, moments, EMA
                   and norm within a relative OPTIM_TAIL_RTOL of the leaf's
                   largest value, the count exact, each kernel launched once
                   a call; then the CUDA-event median
                   of REPS calls of the kernels' launches alone (on a table
                   built once), of the whole wrapper and of the plain version,
                   each one's host time and launches per call, and the bytes
                   bound.  The kernels line gives the tail's launches counted
                   in the strands phase's stage-2 run (``launches_strands``,
                   one of each kernel per step) and the timing loop's own
                   count apart (``launches_per_timed_call``);
19. precompute  -- the fused precompute (``ops/precompute.py``,
                   ``csrc/precompute.cu``) against the composition it
                   replaces (``render/renderer.py: precompute_plain``, on the
                   card, in float32 and in float64) at the two cells'
                   layouts: stage 1's (1M Gaussians, SH 3, the camera
                   through BARF residuals that take gradients) and the
                   strands' (a 100k head and 10,000 x 99 strand segments
                   carrying use_direction, a frozen camera): the forward
                   outputs, every field's gradient, the camera's and its
                   residuals', each no further from the float64 composition
                   than PRE_ERR_FACTOR times the float32 composition is (plus
                   PRE_ERR_FLOOR of its norm), the rows near a branch
                   counted apart, and ndc, conic and depth equal to the
                   float32 composition's bit for bit; two backward runs bit
                   for bit; one launch of each kernel per call; then the
                   CUDA-event median of REPS calls
                   of the forward and backward kernels, beside the bytes
                   bound and the composition's forward + backward.  The
                   train phase requires one forward and one backward launch
                   per step.

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
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "kernel_fwd", "kernel_probe", "kernel_bwd", "train", "viewer", "cli",
          "mesh", "batched", "video", "strands", "kernel_strands", "pipeline", "masks", "tools",
          "quality", "optim_tail", "precompute")

# bench configuration (bench.py:36-99)
P, WIDTH, HEIGHT, N_VIEWS, SEED = 100_000, 960, 544, 4, 0
REPS = 20          # timed repetitions of every CUDA-event timing
# the strand stack at the JAX package's full-width defaults
# (models/textured_strands.py:44-57, models/diffusion.py:30-41); the UNet's
# widths are the defaults of models/diffusion.py
N_STRANDS, STRAND_LEN, TEXTURE, DIFF_INPUT = 10_000, 100, 256, 32
S1_ITERS, STRAND_ITERS = 20, 40
# the pipeline phase: the raw images at 1920x1088 (images_2 is the bench's
# 960x544), 8 views, iterations per stage, the export's strand count
PIPE_WIDTH, PIPE_HEIGHT, PIPE_VIEWS, PIPE_ITERS, EXPORT_STRANDS = 1920, 1088, 8, (30, 20, 20), 30_000
# the card's results against the CPU's: the orientation map (the CPU test's
# tolerances) and the winding number
ORIENT_FILTERED_ATOL, ORIENT_RESP_REL, ORIENT_VAR_ATOL = 1e-5, 1e-4, 1e-4
WINDING_ATOL, WINDING_MARGIN = 1e-9, 1e-6
# the quality phase: the strand gate's floors (tests/test_quality_gate_strands.py:
# 36-44), the stage-1 harness at QUALITY_r05.json's widths and the JAX
# record's test PSNR at 3,000 iterations, the full-width distillation's steps
STAGE2_PSNR_FLOOR, STAGE3_PSNR_FLOOR, CHAMFER_DRIFT_MAX = 22.0, 24.0, 1.5
QR_TEACHER, QR_RES, QR_VIEWS, QR_TEST_VIEWS, QR_ITERS = 50_000, 512, 20, 4, 3000
QR_JAX_TEST_PSNR_3000 = 10.6
DISTILL_STEPS = 100
# the optim_tail phase: the kernel against the per-leaf composition, per leaf
# |got - want| <= OPTIM_TAIL_RTOL * max|want| (only the norm's sum is grouped
# otherwise), the leaf that gets a NaN, the gradients' scales (global norms
# ~0.08 and ~8 against the clip of 1)
OPTIM_TAIL_RTOL = 1e-6
OPTIM_TAIL_NAN_LEAF = 100
OPTIM_TAIL_GRAD_SCALES = {"clip_loose": 1e-5, "clip_binding": 1e-3, "nan_leaf": 1e-5}
TAIL_ENTRIES = ("optim_tail_reduce", "optim_tail_finalize", "optim_tail_update")
# the precompute phase: the two cells' layouts (Gaussians, head rows, SH
# rows stored), and the kernels' results against the composition's in
# float64: a tensor's error norm (over the rows no branch decides) at most
# PRE_ERR_FACTOR times the float32 composition's, plus PRE_ERR_FLOOR of the
# float64 tensor's norm.  Both float32 results round the same operations,
# summed in another order (the composition's 3x3 products are cuBLAS
# GEMMs), so neither is nearer the float64 one by more than a small
# factor.  A row counts as near a branch, and is held apart (left out of the
# forward's comparison, its cotangent set to 0), where the float64 view-space
# x / z or y / z lies within PRE_NEAR (relative) of the 1.3 tan_fov clamp or
# a colour's value before the clamp at 0 within PRE_NEAR of 0: there the two
# float32 results may take different sides.  The principal axis is no such
# branch here: the scales are float32 in both and the modifier is 1, so
# every comparison of them, ties at the 0.01 cap included, is the same
# comparison
PRE_S1, PRE_HEAD, PRE_HAIR, PRE_SH_DEGREE = 1_000_000, 100_000, N_STRANDS * (STRAND_LEN - 1), 3
PRE_ERR_FACTOR, PRE_ERR_FLOOR, PRE_NEAR = 2.0, 1e-7, 1e-5
# the forward outputs that must equal the float32 composition's bit for bit
PRE_BITWISE = ("ndc", "conic", "depth")
# the tools phase: pipeline_e2e_run.build_scene at its defaults, the
# converters' distillation steps, the lr probe's iterations and lrs, and the
# LPIPS distance on the card against the CPU's (float32 convolutions both)
E2E_VIEWS, E2E_RES = 24, 1024
NH_STEPS, IQA_STEPS = 100, 200
PROBE_ITERS, PROBE_LRS, PROBE_VIEWS, PROBE_TEST_VIEWS = 20, "0.2,0.02", 16, 4
LPIPS_CARD_RTOL = 1e-3
# the viewing and masking entry points: render_video's frames, the viewer's
# training iterations and the iterations whose poll gets a 960x544 request
# (the last one with keep_alive), the pipeline views calc_masks runs on
VIDEO_FRAMES = 24
VIEWER_ITERS, VIEWER_ASKS = 20, (2, 10, 20)
MASK_VIEWS = ("000000.png", "000004.png")
# the mesh phase: the CLI run's iterations and its one densification
MESH_ITERS, MESH_DENSIFY = 30, 20
# tests/test_parallel.py's tolerances, held by the mesh phase's steps
MESH_TOL = {"metrics": (2e-4, 1e-5), "params": (1e-3, 2e-5), "cam_res": (1e-3, 1e-6),
            "xyz_grad_accum": (1e-3, 1e-7), "denom": (0.0, 1e-6), "max_radii2d": (0.0, 1e-5)}
# the batched phase: the batch sizes timed, the synchronized steps timed at
# each, the loop's iterations and its one densification, and the tolerance
# of a batched render's parameter gradients against four single renders'
# summed (|got - want| <= atol_frac * max|want| + rtol * |want|, per tensor:
# the float64 segment scan and the precompute's accumulation run in another
# order)
BATCH_SIZES, BATCH_REPS, BATCH_ITERS, BATCH_DENSIFY = (1, 2, 4), 20, 20, 10
BATCH_GRAD_TOL = {"rtol": 1e-4, "atol_frac": 1e-5}
# what the compositing kernels' grid may hold (csrc/raster_common.cuh: tile_origin)
GRID_NOTE = ("one image, a window of its rows from row0, or B images stacked as a "
             "virtual grid of B*gy tile rows (a tile's row in its image: (tile // gx) % gy)")
# two ranks on this card: NCCL, then gloo with CUDA tensors in each collective
NCCL_PROBE = """
import torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl")
t = torch.ones(4, device="cuda:0")
dist.all_reduce(t)
torch.cuda.synchronize()
print("nccl all_reduce on a shared card:", t.tolist())
dist.destroy_process_group()
"""
GLOO_PROBE = """
import json, torch, torch.distributed as dist
dist.init_process_group("gloo")
dev, r = torch.device("cuda:0"), dist.get_rank()
ops = {
    "all_reduce": lambda: dist.all_reduce(torch.full((8,), r + 1.0, device=dev)),
    "all_reduce_max_int64": lambda: dist.all_reduce(torch.full((8,), r, device=dev),
                                                    op=dist.ReduceOp.MAX),
    "all_gather": lambda: dist.all_gather([torch.zeros(8, device=dev) for _ in range(2)],
                                          torch.full((8,), r + 1.0, device=dev)),
}
out = {}
for name, op in ops.items():
    # an op gloo refuses for CUDA tensors raises on both ranks before any
    # message, so the next op still pairs up; what each raised is the record
    try:
        op()
        torch.cuda.synchronize()
        out[name] = "ok"
    except (RuntimeError, ValueError) as e:
        out[name] = str(e).splitlines()[0][:200]
if r == 0:
    print("GLOO_CUDA " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (pixel, instance) pair, counted from the kernels'
# source: a pair evaluated before its pixel stops, in a warp the exact
# per-warp cull keeps, costs the exponent (dx, dy and the quadratic form,
# 11), exp (1), op * e (1), the clamp and two compares (3) = 16; a blended
# pair adds 1 - alpha, T (1 - alpha), alpha T and 10 colour FMAs (23).  The
# backward's blended pair adds u (20), prefix / suffix / d alpha (7), the six
# geometry terms (14), ten colour terms (10) and the 16-term pixel
# reduction (16) = 67 more, 90 in all.  The culled pairs can neither blend
# nor stop a pixel, so the bound counts none of their operations; the
# phases also print the bound that counts every visited pair, culled or not
# (``bound_ms_uncut``), which does not depend on the cull.
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


def seeded_cotangent(torch, cfg, dev, n_batch=None):
    """A seeded tile-buffer cotangent of one image, or of ``n_batch``."""
    from gaussianhaircut_torch.ops.rasterize import common as C
    from gaussianhaircut_torch.render.renderer import default_background
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    lead = () if n_batch is None else (n_batch,)
    g_img = torch.randn(lead + (C.NUM_CHANNELS, HEIGHT, WIDTH), generator=gen, device=dev)
    g_t = torch.randn(lead + (HEIGHT, WIDTH), generator=gen, device=dev)
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


def ptxas_summary(logs: dict) -> dict:
    """Registers and spill bytes of every kernel, from ``-Xptxas -v``."""
    out, name = {}, None
    for line in "\n".join(logs.values()).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name].update(spill_store_bytes=int(st), spill_load_bytes=int(ld))
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def cull_stats(binned, width, height, cfg) -> tuple:
    """The card's per-warp cull masks on a layout, held against their plain
    mirror on the same payload -> (the (instance, warp) pairs they keep
    over the used chunks' total, the masks)."""
    from gaussianhaircut_torch.ops.rasterize import cuda_core, plain_core
    lay = (binned.payload, binned.chunk_start, binned.nchunks)
    card = cuda_core.warp_masks(*lay, width, height, cfg)
    plain = plain_core.warp_masks_plain(*lay, width, cfg)
    mismatched = int((card != plain).sum())
    require(mismatched == 0, f"cull: {mismatched} of the card's warp masks differ "
            "from the plain mirror's")
    nwarps = cfg.tile_pix // 32
    kept = sum(int(((card >> w) & 1).sum()) for w in range(nwarps))
    total = int(binned.nchunks.sum()) * cfg.chunk * nwarps
    return ({"pairs_kept": kept, "pairs_total": total, "kept_share": kept / total,
             "masks_mismatched": mismatched}, plain)


def layout_stats(binned, n_head: int) -> dict:
    """Instances, the hair rows' share of them (rows from ``n_head`` on),
    chunks and the largest chunk count of any tile of a binned layout."""
    nr = binned.num_rendered
    hair = int(binned.gauss_count[n_head:].sum())
    return {"num_rendered": nr, "hair_instances": hair, "hair_share": hair / max(nr, 1),
            "chunks": int(binned.nchunks.sum()), "max_chunks_per_tile": int(binned.nchunks.max()),
            "tiles_over_one_chunk": int((binned.nchunks > 1).sum())}


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    t_start = time.perf_counter()
    phases = args.phases.split(",")
    for ph in phases:
        require(ph in PHASES, f"unknown phase {ph!r}")
    require("kernel_strands" not in phases or "strands" in phases,
            "kernel_strands holds the kernels at the layout the strands phase trains")
    require("pipeline" not in phases or "strands" in phases,
            "pipeline renders its scene from the layout the strands phase trains")
    require("video" not in phases or "cli" in phases,
            "video renders the model the cli phase trains")
    require("mesh" not in phases or "cli" in phases,
            "mesh starts from the scene and the checkpoint the cli phase writes")
    require("batched" not in phases or "cli" in phases,
            "batched starts from the scene and the checkpoint the cli phase writes")
    require("masks" not in phases or "pipeline" in phases,
            "masks runs on the views of the pipeline phase's scene")
    require("tools" not in phases or "strands" in phases,
            "tools probes the stage-2 checkpoint and renders the layout the strands phase trains")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from gaussianhaircut_torch import kernels as loader
        from gaussianhaircut_torch.ops.rasterize import common as C
        from gaussianhaircut_torch.ops.rasterize import cuda_core, plain_core
        from gaussianhaircut_torch.ops.rasterize.api import segment_sum
        from gaussianhaircut_torch.tools.profile_fixed import (
            binned_inputs, cuda_ms, nvidia_smi)
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
                       "grid": GRID_NOTE, "library_ms": None},
        "raster_bwd": {"name": "raster_bwd", "route": "cuda",
                       "source": "gaussianhaircut_torch/csrc/raster_bwd.cu",
                       "replaces": "gaussianhaircut_tpu/ops/rasterize/pallas_core.py:938",
                       "grid": GRID_NOTE, "library_ms": None},
        "raster_probe": {"name": "raster_probe", "route": "cuda",
                         "source": "gaussianhaircut_torch/csrc/raster_probe.cu",
                         "replaces": "tools/tpu_profile_r4.py:493",
                         "library_ms": None},
        "optim_tail": {"name": "optim_tail", "route": "cuda",
                       "source": "gaussianhaircut_torch/csrc/optim_tail.cu",
                       "replaces": None, "added_for": "stage 2's per-leaf optimizer tail "
                       "(train/stage2.py: train_step), ~30 launches per leaf",
                       "library_ms": None},
        "precompute": {"name": "precompute", "route": "cuda",
                       "source": "gaussianhaircut_torch/csrc/precompute.cu",
                       "replaces": None, "added_for": "the precompute's chain of small "
                       "PyTorch ops (render/renderer.py: precompute_plain), cuBLAS batched "
                       "3x3 GEMMs, ~750 launches per camera", "library_ms": None},
    }

    if "env" in phases:
        emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "tf32": [torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32]})

    t0 = time.perf_counter()
    logs = loader.build(verbose=True)
    build_s = time.perf_counter() - t0
    if "build" in phases:
        emit({"phase": "build", "seconds": round(build_s, 3),
              "ptxas": ptxas_summary(logs),
              "blocks_per_sm": {name: cuda_core.blocks_per_sm(name, cfg)
                                for name in loader.SOURCES if name.startswith("raster")}})

    from gaussianhaircut_torch.scene.synthetic import bench_scene
    scene = bench_scene(P, WIDTH, HEIGHT, N_VIEWS, SEED)
    fwd_tile_buf = None
    binned = None
    if any(ph in phases for ph in ("kernel_fwd", "kernel_probe", "kernel_bwd")):
        from gaussianhaircut_torch.models import gaussian_model as gm
        model = gm.create_from_pcd(scene.points, scene.colors, P, 3, 1.0, dev)
        binned, _ = binned_inputs(model.params, model.aux.alive, 3, scene,
                                  0, cfg, dev)
        lay = (binned.payload, binned.chunk_start, binned.nchunks)
        used_chunks = int(binned.nchunks.sum())
        in_bytes = used_chunks * 16 * cfg.chunk * 4 + 2 * binned.num_tiles * 4
        buf_bytes = binned.num_tiles * cfg.tile_pix * C.PAD_CHANNELS * 4
        culled, masks = cull_stats(binned, WIDTH, HEIGHT, cfg)
        stats = {}
        plain_buf = plain_core.raster_fwd_plain(*lay, WIDTH, HEIGHT, cfg, stats=stats,
                                                masks=masks)
        fwd_tile_buf = cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg)
        torch.cuda.synchronize()
        ops_fwd = stats["kept"] * OPS_VISIT + stats["contrib"] * OPS_BLEND_FWD
        ops_bwd = stats["kept"] * OPS_VISIT + stats["contrib"] * OPS_BLEND_BWD
        uncut = stats["visited"] - stats["kept"]

    if "kernel_fwd" in phases:
        # the cull skips only pairs that can neither blend nor stop a pixel,
        # so the kernel's tile buffer is the plain version's bit for bit
        err = (fwd_tile_buf - plain_buf).abs().amax(dim=(0, 1))
        err_col = float(torch.cat([err[:9], err[15:16]]).max())
        err_depth = float(err[9])
        done_mismatch = int((fwd_tile_buf[..., C.CH_DONE] != plain_buf[..., C.CH_DONE]).sum())
        require(bool(torch.isfinite(fwd_tile_buf).all()), "forward kernel: non-finite output")
        require(torch.equal(fwd_tile_buf, plain_buf),
                f"forward kernel: not bit-identical to its plain version (colour/T "
                f"error {err_col}, depth error {err_depth}, {done_mismatch} done-latch "
                "mismatches)")
        ms = cuda_ms(lambda: cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg), REPS)
        plain_ms = cuda_ms(lambda: plain_core.raster_fwd_plain(
            *lay, WIDTH, HEIGHT, cfg), REPS)
        b_ms, b_by = bound_ms(in_bytes + buf_bytes, ops_fwd)
        kernels["raster_fwd"].update(max_abs_err=max(err_col, err_depth), ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "kernel_fwd", "num_rendered": binned.num_rendered,
              "tiles": binned.num_tiles, "chunks_used": used_chunks,
              "pairs_visited": stats["visited"], "pairs_visited_kept": stats["kept"],
              "pairs_blended": stats["contrib"],
              "max_err_colour_T": err_col, "max_err_depth": err_depth,
              "done_latch_mismatches": done_mismatch, "bit_identical": True,
              "cull": culled, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by, "bound_ms_uncut": bound_ms(
                  in_bytes + buf_bytes, ops_fwd + uncut * OPS_VISIT)[0],
              "launches": loader.launches["raster_fwd"]})

    if "kernel_probe" in phases:
        emit(probe_phase(torch, binned, cfg, in_bytes + buf_bytes, kernels))

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
        ms = cuda_ms(lambda: cuda_core.raster_bwd(*bargs), REPS)
        plain_ms = cuda_ms(lambda: plain_core.raster_bwd_plain(*bargs), REPS)
        nbytes = in_bytes + 2 * buf_bytes + used_chunks * C.GRAD_ROWS * cfg.chunk * 4
        b_ms, b_by = bound_ms(nbytes, ops_bwd)
        kernels["raster_bwd"].update(max_abs_err=max_err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "kernel_bwd", "rows": rows, "max_abs_err": max_err,
              "bit_identical": True, "cull": culled, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by,
              "bound_ms_uncut": bound_ms(nbytes, ops_bwd + uncut * OPS_VISIT)[0]})
        del plain, d1, d2

    if "train" in phases:
        emit(train_phase(torch, scene, cfg, dev, kernels))

    if "viewer" in phases:
        t0 = time.perf_counter()
        res = viewer_phase(torch, scene, dev)
        res["seconds"] = time.perf_counter() - t0
        for name in ("raster_fwd", "raster_bwd"):
            kernels[name]["launches_viewer"] = res["launches"][name]
        emit(res)

    if "cli" in phases:
        import tempfile
        with tempfile.TemporaryDirectory(prefix="ghsmoke_") as root:
            emit(cli_phase(torch, root))
            if "mesh" in phases:
                res = mesh_phase(torch, root)
                for name in ("raster_fwd", "raster_bwd"):
                    kernels[name]["launches_mesh"] = res["launches_mesh"][name]
                emit(res)
            if "batched" in phases:
                res = batched_phase(torch, root, cfg, kernels)
                for name in ("raster_fwd", "raster_bwd"):
                    kernels[name]["launches_batched"] = res["loop"]["launches"][name]
                emit(res)
            if "video" in phases:
                t0 = time.perf_counter()
                res = video_phase(torch, root)
                res["seconds"] = time.perf_counter() - t0
                for name in ("raster_fwd", "raster_bwd"):
                    kernels[name]["launches_video"] = res["launches"][name]
                emit(res)

    if "strands" in phases:
        import tempfile
        with tempfile.TemporaryDirectory(prefix="ghtools_") as tools_root:
            ck2 = os.path.join(tools_root, "stage2.npz") if "tools" in phases else None
            t0 = time.perf_counter()
            res, layout = strands_phase(torch, cfg, dev, keep_ckpt=ck2)
            res["seconds"] = time.perf_counter() - t0
            for name in ("raster_fwd", "raster_bwd"):
                kernels[name]["launches_strands"] = {
                    st: res[st]["launches"][name] for st in ("stage2", "stage3")}
            # stage 2 is the fused tail's one caller on the main path
            kernels["optim_tail"]["launches_strands"] = {
                k: res["stage2"]["launches"][f"optim_tail_{k}"]
                for k in ("reduce", "finalize", "update")}
            emit(res)
            if "kernel_strands" in phases:
                t0 = time.perf_counter()
                res = kernel_strands_phase(torch, layout, cfg)
                res["seconds"] = time.perf_counter() - t0
                emit(res)
            if "pipeline" in phases:
                masks = {}
                t0 = time.perf_counter()
                res = pipeline_phase(torch, layout, cfg, then=(
                    lambda data, root: masks.update(masks_phase(torch, data, root)))
                    if "masks" in phases else None)
                res["seconds"] = time.perf_counter() - t0 - masks.get("seconds", 0.0)
                for name in ("raster_fwd", "raster_bwd"):
                    kernels[name]["launches_pipeline"] = res["launches"][name]
                emit(res)
                if masks:
                    emit(masks)
            if "tools" in phases:
                t0 = time.perf_counter()
                res = tools_phase(torch, tools_root, ck2, scene, layout[0], cfg, dev)
                res["seconds"] = time.perf_counter() - t0
                for name in ("raster_fwd", "raster_bwd"):
                    kernels[name]["launches_tools"] = {
                        part: res[part]["launches"][name] for part in TOOL_PARTS}
                emit(res)
            del layout

    if "quality" in phases:
        t0 = time.perf_counter()
        res = quality_phase(torch, dev)
        res["seconds"] = time.perf_counter() - t0
        for name in ("raster_fwd", "raster_bwd"):
            kernels[name]["launches_quality"] = {k: res[k]["launches"][name]
                                                 for k in ("strand_gate", "quality_run")}
        emit(res)

    if "optim_tail" in phases:
        emit(optim_tail_phase(torch, dev, kernels))

    if "precompute" in phases:
        t0 = time.perf_counter()
        res = precompute_phase(torch, scene, dev, kernels)
        res["seconds"] = time.perf_counter() - t0
        emit(res)

    complete = all(ph in phases for ph in PHASES)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    if complete:
        for k in kernels.values():
            # a kernel's launches counted on the main path: stage 1's train()
            # for the compositing kernels, stage 2 for the optimizer tail
            counted = "launches_strands" if k["name"] == "optim_tail" else "launches"
            missing = {counted, "max_abs_err", "ms", "plain_ms", "bound_ms",
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


def optim_tail_phase(torch, dev, kernels):
    """Stage 2's fused optimizer tail against its plain version on the card,
    then both timed (see the module docstring, item 18)."""
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.models.diffusion import Denoiser, DiffusionConfig
    from gaussianhaircut_torch.models.strand_prior import ColorDecoder, StrandDecoder
    from gaussianhaircut_torch.models.textured_strands import (
        StrandParams, TexturedStrandsConfig)
    from gaussianhaircut_torch.tools.profile_fixed import cuda_ms
    from gaussianhaircut_torch.train import optim, optim_tail

    scfg = TexturedStrandsConfig()
    channels = scfg.geometry_descriptor_size + scfg.appearance_descriptor_size
    with torch.device("meta"):
        mods = StrandParams(torch.empty(TEXTURE, TEXTURE, channels),
                            StrandDecoder(length=STRAND_LEN), ColorDecoder(sh_degree=3),
                            Denoiser(DiffusionConfig(input_channels=scfg.geometry_descriptor_size,
                                                     input_size=DIFF_INPUT)))
    shapes = {n: p.shape for n, p in mods.named_parameters()}
    ema_names = [n for n in shapes if n.startswith("denoiser.")]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda shape, s: s * torch.randn(shape, generator=gen, device=dev)
    params = {n: rand(s, 0.05) for n, s in shapes.items()}
    state = {"params": params,
             "opt": optim.AdamState({n: rand(s, 1e-4) for n, s in shapes.items()},
                                    {n: rand(s, 1e-4).square() for n, s in shapes.items()},
                                    torch.tensor(41, dtype=torch.int32, device=dev)),
             "ema": {n: params[n] + rand(shapes[n], 1e-3) for n in ema_names}}
    twin = {"params": {n: p.clone() for n, p in state["params"].items()},
            "opt": optim.AdamState({n: t.clone() for n, t in state["opt"].mu.items()},
                                   {n: t.clone() for n, t in state["opt"].nu.items()},
                                   state["opt"].count.clone()),
            "ema": {n: e.clone() for n, e in state["ema"].items()}}
    pairs = lambda st: [(st["ema"][n], st["params"][n]) for n in ema_names]
    lr, clip = 3e-4, 1.0

    def tensors(st):
        out = {f"p/{n}": p for n, p in st["params"].items()}
        out.update({f"m/{n}": t for n, t in st["opt"].mu.items()})
        out.update({f"v/{n}": t for n, t in st["opt"].nu.items()})
        out.update({f"e/{n}": e for n, e in st["ema"].items()})
        return out

    steps = {}
    for name, scale in OPTIM_TAIL_GRAD_SCALES.items():
        grads = {n: rand(s, scale) for n, s in shapes.items()}
        if name == "nan_leaf":
            grads[list(shapes)[OPTIM_TAIL_NAN_LEAF]].view(-1)[7] = float("nan")
        before = {k: t.clone() for k, t in tensors(state).items()}
        count0 = int(state["opt"].count)
        loader.reset_launch_counts()
        got = optim_tail.adamw_tail_(state["params"], grads, state["opt"], pairs(state), lr, clip)
        want = optim_tail.adamw_tail_plain_(twin["params"], grads, twin["opt"], pairs(twin), lr,
                                            clip)
        torch.cuda.synchronize()
        require(all(loader.launches[k] == 1 for k in TAIL_ENTRIES),
                f"optim_tail: one call launched {loader.launches}")
        a, b = tensors(state), tensors(twin)
        rel = {k: float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30))
               for k in b}
        worst = max(rel, key=rel.get)
        gn, gn_want = float(got), float(want)
        gn_rel = abs(gn - gn_want) / gn_want if np.isfinite(gn_want) else None
        steps[name] = {"grad_norm": gn, "grad_norm_plain": gn_want, "grad_norm_rel": gn_rel,
                       "max_rel_err": rel[worst], "worst": worst,
                       "max_abs_err": max(float((a[k] - b[k]).abs().max()) for k in b),
                       "bit_identical_tensors": sum(torch.equal(a[k], b[k]) for k in b),
                       "tensors": len(b), "count": int(state["opt"].count),
                       "count_plain": int(twin["opt"].count)}
        require(rel[worst] <= OPTIM_TAIL_RTOL, f"optim_tail {name}: {worst} is {rel[worst]} "
                f"off its plain version (relative to its largest value)")
        require(steps[name]["count"] == steps[name]["count_plain"],
                f"optim_tail {name}: count {steps[name]['count']} against "
                f"{steps[name]['count_plain']}")
        if name == "nan_leaf":
            require(not np.isfinite(gn) and steps[name]["count"] == count0
                    and all(torch.equal(a[k], before[k]) for k in a if not k.startswith("e/"))
                    and all(not torch.equal(a[k], before[k]) for k in a if k.startswith("e/")),
                    "optim_tail nan_leaf: the step moved the parameters, moments or count, or "
                    "left the EMA")
        else:
            require(gn_rel <= OPTIM_TAIL_RTOL, f"optim_tail {name}: grad norm {gn} against "
                    f"{gn_want}")
            require(steps[name]["count"] == count0 + 1, f"optim_tail {name}: count not advanced")
            require((gn > clip) == (name == "clip_binding"),
                    f"optim_tail {name}: grad norm {gn} against the clip {clip}")
        del before, grads

    grads = {n: rand(s, OPTIM_TAIL_GRAD_SCALES["clip_loose"]) for n, s in shapes.items()}
    kernel = lambda: optim_tail.adamw_tail_(state["params"], grads, state["opt"], pairs(state),
                                            lr, clip)
    plain = lambda: optim_tail.adamw_tail_plain_(twin["params"], grads, twin["opt"],
                                                 pairs(twin), lr, clip)
    # the launches alone, on a table built once: the kernels' device time
    table, grid = optim_tail.tail_tables(state["params"], grads, state["opt"], pairs(state))
    launched = lambda: optim_tail.launch_tail(table, grid, state["opt"].count, lr, clip)
    timing = {}
    for path, fn in (("kernel", launched), ("wrapper", kernel), ("plain", plain)):
        ms = cuda_ms(fn, REPS)
        torch.cuda.synchronize()
        loader.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host_ms = (time.perf_counter() - t0) / REPS * 1e3
        torch.cuda.synchronize()
        launches = {k: v for k, v in loader.launches.items() if v}
        timing[path] = {"ms": ms, "host_ms_per_call": host_ms,
                        "launches_per_call": {k: v / REPS for k, v in launches.items()}}
    n_all = sum(p.numel() for p in params.values())
    n_ema = sum(params[n].numel() for n in ema_names)
    # reduce reads g; update reads g, p, m, v, writes p, m, v; the EMA reads and writes e
    nbytes = 4 * (n_all + 4 * n_all + 3 * n_all + 2 * n_ema)
    b_ms, b_by = bound_ms(nbytes, 0)
    ms = timing["kernel"]["ms"]
    kernels["optim_tail"].update(
        launches_per_timed_call=timing["kernel"]["launches_per_call"], ms=ms,
        plain_ms=timing["plain"]["ms"],
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(st["max_abs_err"] for st in steps.values()))
    return {"phase": "optim_tail", "leaves": len(shapes), "ema_leaves": len(ema_names),
            "parameters": n_all, "ema_parameters": n_ema, "steps": steps, "timing": timing,
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}


def precompute_layout(torch, n, n_head, dev, seed):
    """Activated fields of ``n`` Gaussians on the card (float32): a blob at
    the bench scene's spread; with ``n_head`` < ``n`` the rows from
    ``n_head`` on are strand segments (one long axis, ~2 mm across, 2-D
    direction on) and the rows before them the head's (direction off)."""
    from gaussianhaircut_torch.ops.quaternion import build_rotation
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    rows = (PRE_SH_DEGREE + 1) ** 2
    scaling = torch.exp(rnd(n, 3) * 0.5 - 5.0).clamp(max=0.01)
    f = {"xyz": 0.3 * rnd(n, 3), "features": 0.3 * rnd(n, rows, 3), "scaling": scaling,
         "rotation_matrix": build_rotation(rnd(n, 4)),
         "label": torch.rand(n, 1, generator=gen, device=dev),
         "orient_conf": torch.rand(n, 1, generator=gen, device=dev) + 0.5,
         "viewspace": torch.zeros(n, 3, device=dev), "use_direction": None}
    if n_head < n:
        f["scaling"][n_head:] = torch.tensor([0.004, 0.001, 0.001], device=dev)
        f["use_direction"] = (torch.arange(n, device=dev) >= n_head).float()
    return f


def near_branch(torch, f64, cam64, deg):
    """[P] bool: the rows near a branch of the precompute (see PRE_NEAR),
    from the float64 fields and camera."""
    from gaussianhaircut_torch.ops import sh as sh_ops
    from gaussianhaircut_torch.ops.quaternion import normalize
    t = f64["xyz"] @ cam64.viewmatrix[:3, :3] + cam64.viewmatrix[3, :3]
    near = torch.zeros(t.shape[0], dtype=torch.bool, device=t.device)
    for k, tan in ((0, cam64.tan_fovx), (1, cam64.tan_fovy)):
        lim = 1.3 * tan
        near |= ((t[:, k] / t[:, 2]).abs() - lim).abs() <= PRE_NEAR * lim
    raw = sh_ops.eval_sh(deg, f64["features"], normalize(f64["xyz"] - cam64.campos)) + 0.5
    near |= (raw.abs() <= PRE_NEAR).any(-1)
    return near


def precompute_phase(torch, scene, dev, kernels):
    """The fused precompute against the composition at the two cells'
    layouts, then its kernels timed (see the module docstring, item 19)."""
    import dataclasses
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.ops import precompute as pre_ops
    from gaussianhaircut_torch.render import renderer
    from gaussianhaircut_torch.scene.cameras import CameraBatch, CameraResiduals, camera_geom
    from gaussianhaircut_torch.tools.profile_fixed import cuda_ms, scene_camera

    fields_names = ("xyz", "features", "scaling", "rotation_matrix", "label", "orient_conf",
                    "viewspace")
    cam_names = ("viewmatrix", "projmatrix", "campos", "tan_fovx", "tan_fovy")
    deg = PRE_SH_DEGREE
    cam0 = scene_camera(scene, 0, dev)
    cb = CameraBatch.from_cameras(scene.train_cameras, dev)
    out = {"phase": "precompute"}
    for name, n, n_head, cam_grad in (("s1", PRE_S1, PRE_S1, True),
                                      ("strands", PRE_HEAD + PRE_HAIR, PRE_HEAD, False)):
        f = precompute_layout(torch, n, n_head, dev, SEED + 7)
        cam = {k: getattr(cam0, k).detach().clone() for k in cam_names}
        f64 = {k: None if v is None else v.double() for k, v in f.items()}
        cam64 = dataclasses.replace(cam0, **{k: v.double() for k, v in cam.items()})
        near = near_branch(torch, f64, cam64, deg)
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        keep = (~near).float()
        cot = [torch.randn(shape, generator=gen, device=dev) * keep.view(-1, *[1] * (len(shape) - 1))
               for shape in ((n, 3), (n, 3), (n, 10), (n,))]
        cot[0] = cot[0] * 0.01        # NDC cotangents of pixel-sized steps' scale

        def inputs(dtype):
            leaves = {k: f[k].to(dtype).clone().requires_grad_(True) for k in fields_names}
            ud = None if f["use_direction"] is None else f["use_direction"].to(dtype)
            fl = renderer.GaussianFields(opacity=torch.ones_like(leaves["label"]),
                                         valid=torch.ones(n, dtype=torch.bool, device=dev),
                                         use_direction=ud, **leaves)
            if cam_grad:   # the camera through BARF residuals, as stage 1 trains it
                res = CameraResiduals(*(torch.zeros(k, dtype=dtype, device=dev,
                                                    requires_grad=True) for k in (3, 3, 2)))
                geom = camera_geom(cb.colmap_transform[0].to(dtype), cb.fovx[0].to(dtype),
                                   cb.fovy[0].to(dtype), cam0.width, cam0.height, res, None,
                                   use_barf=True)
                cam_t = [getattr(geom, k) for k in cam_names] + [res.rotation,
                                                                 res.translation, res.fov]
            else:
                geom = dataclasses.replace(cam0, **{k: cam[k].to(dtype) for k in cam_names})
                cam_t = []
            return fl, geom, list(leaves.values()) + cam_t, [c.to(dtype) for c in cot]

        def run(route, dtype, args=None):
            fl, geom, wrt, cots = args or inputs(dtype)
            outs = (renderer.precompute if route == "kernel" else renderer.precompute_plain)(
                fl, deg, geom)
            grads = torch.autograd.grad(outs, wrt, cots, retain_graph=True, allow_unused=True)
            return outs, grads, (outs, wrt, cots)

        loader.reset_launch_counts()
        k_out, k_grads, k_graph = run("kernel", torch.float32)
        k_grads2 = torch.autograd.grad(*k_graph, allow_unused=True)
        torch.cuda.synchronize()
        launched = {k: loader.launches[f"precompute_{k}"] for k in ("fwd", "bwd", "cam_reduce")}
        require(launched == {"fwd": 1, "bwd": 2, "cam_reduce": 2 if cam_grad else 0},
                f"precompute {name}: launches {launched} for one forward and two backwards")
        require(all(torch.equal(a, b) for a, b in zip(k_grads, k_grads2)),
                f"precompute {name}: two backward runs differ")
        p_out, p_grads, _ = run("plain", torch.float32)
        r_out, r_grads, _ = run("plain", torch.float64)
        del k_graph
        # what the binning and the compositing kernels decide on is the
        # composition's bit for bit (csrc/precompute.cu rounds as cuBLAS
        # and PyTorch's elementwise ops do); the colours are compared below
        mismatched = {tname: int((a.detach() != b.detach()).sum()) for tname, a, b in
                      zip(("ndc", "conic", "colors", "depth"), k_out, p_out)}
        require(not any(mismatched[k] for k in PRE_BITWISE),
                f"precompute {name}: the forward's {PRE_BITWISE} differ from the "
                f"composition's in {mismatched} elements")
        names = ["ndc", "conic", "colors", "depth"] + list(fields_names) + (
            [f"cam.{k}" for k in cam_names] + ["residual.rotation", "residual.translation",
                                               "residual.fov"] if cam_grad else [])
        rows = {}
        for i, tname in enumerate(names):
            is_out = i < 4
            got = (k_out if is_out else k_grads)[i if is_out else i - 4]
            plain = (p_out if is_out else p_grads)[i if is_out else i - 4]
            ref = (r_out if is_out else r_grads)[i if is_out else i - 4]
            got, plain, ref = (t.detach() for t in (got, plain, ref))
            if is_out:     # the forward's rows near a branch are held apart
                got, plain, ref = got[~near], plain[~near], ref[~near]
            ref_norm = float(ref.norm())
            err_k = float((got.double() - ref).norm())
            err_p = float((plain.double() - ref).norm())
            limit = PRE_ERR_FACTOR * err_p + PRE_ERR_FLOOR * ref_norm
            rows[tname] = {"err_kernel": err_k, "err_composition": err_p, "norm": ref_norm,
                           "limit": limit, "max_abs_kernel_vs_composition":
                           float((got - plain).abs().max()), "bit_identical": torch.equal(got, plain)}
            require(ref_norm > 0 or tname in ("viewspace",), f"precompute {name}: {tname} is 0 "
                    "in float64, so the check cannot fail")
            require(bool(torch.isfinite(got).all()), f"precompute {name}: {tname} not finite")
            require(err_k <= limit, f"precompute {name}: {tname} is {err_k} from the float64 "
                    f"composition, the float32 composition {err_p} (limit {limit})")
        del p_out, p_grads, r_out, r_grads, k_grads2
        out[name] = {"gaussians": n, "head_rows": n_head, "sh_degree": deg,
                     "camera_gradient": cam_grad, "near_branch_rows": int(near.sum()),
                     "forward_mismatched_elements": mismatched,
                     "launches": launched, "tensors": rows,
                     "max_abs_err": max(r["max_abs_kernel_vs_composition"] for r in rows.values())}

        # timing: the kernels alone (launched directly, ten per timed call),
        # then forward + backward through the wrapper and through the
        # composition, each a CUDA-event median of REPS calls
        xs = [f[k].contiguous() for k in fields_names]
        ud = f["use_direction"]
        packed = torch.cat([cam["viewmatrix"].reshape(16), cam["projmatrix"].reshape(16),
                            cam["campos"].reshape(3), cam["tan_fovx"].reshape(1),
                            cam["tan_fovy"].reshape(1)])
        rows_sh = f["features"].shape[1]
        o = [torch.empty(n, 3, device=dev), torch.empty(n, 3, device=dev),
             torch.empty(n, 10, device=dev), torch.empty(n, device=dev)]
        g = [torch.empty_like(xs[i]) for i in range(4)] + [torch.empty(n, 1, device=dev)
                                                             for _ in range(2)]
        blocks = -(-n // pre_ops.THREADS)
        part = torch.empty(blocks, pre_ops.CAM_VALUES, dtype=torch.float64, device=dev)
        flat = torch.empty(pre_ops.CAM_FLOATS, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = lambda t: None if t is None else t.data_ptr()
        W, H = cam0.width, cam0.height

        def fwd():
            for _ in range(10):
                loader.launch("precompute_fwd", *map(ptr, xs), ptr(ud), packed.data_ptr(),
                                 *map(ptr, o), n, rows_sh, deg, W, H, 1.0, stream)

        def bwd():
            for _ in range(10):
                loader.launch("precompute_bwd", *map(ptr, xs[:4]), ptr(ud), packed.data_ptr(),
                                 *map(ptr, cot), *map(ptr, g), ptr(part) if cam_grad else None,
                                 n, rows_sh, deg, W, H, 1.0, stream)
                if cam_grad:
                    loader.launch("precompute_cam_reduce", part.data_ptr(), blocks,
                                     flat.data_ptr(), stream)

        args = inputs(torch.float32)
        fwd_ms, bwd_ms = cuda_ms(fwd, REPS) / 10, cuda_ms(bwd, REPS) / 10
        wrapper_ms = cuda_ms(lambda: run("kernel", torch.float32, args), REPS)
        plain_ms = cuda_ms(lambda: run("plain", torch.float32, args), REPS)
        ud_b = 0 if ud is None else 4
        fwd_bytes = n * (4 * (3 + 3 * rows_sh + 3 + 9 + 1 + 1 + 3) + ud_b + 4 * (3 + 3 + 10 + 1))
        bwd_bytes = n * (4 * (3 + 3 * rows_sh + 3 + 9) + ud_b + 4 * (3 + 3 + 10 + 1)
                         + 4 * (3 + 3 * rows_sh + 3 + 9 + 1 + 1))
        if cam_grad:
            bwd_bytes += 2 * blocks * pre_ops.CAM_VALUES * 8
        b_fwd, _ = bound_ms(fwd_bytes, 0)
        b_bwd, _ = bound_ms(bwd_bytes, 0)
        out[name]["timing"] = {
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_bytes": fwd_bytes, "bwd_bytes": bwd_bytes,
            "fwd_bound_ms": b_fwd, "bwd_bound_ms": b_bwd, "fwd_share": b_fwd / fwd_ms,
            "bwd_share": b_bwd / bwd_ms, "wrapper_fwd_bwd_ms": wrapper_ms,
            "composition_fwd_bwd_ms": plain_ms}
        if name == "s1":
            kernels["precompute"].update(
                ms=fwd_ms + bwd_ms, plain_ms=plain_ms, bound_ms=b_fwd + b_bwd, bound_by="bytes",
                max_abs_err=out[name]["max_abs_err"])
        del f, f64, xs, o, g, cot, args
        torch.cuda.empty_cache()
    return out


def probe_phase(torch, binned, cfg, nbytes, kernels):
    """The fixed-cost probe against its plain version on the forward's
    layout, then the profiling path (``profile_fixed.measure``) with the
    launch counts set to 0 just before it."""
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.ops.rasterize import cuda_core, plain_core
    from gaussianhaircut_torch.tools.profile_fixed import cuda_ms, measure
    lay = (binned.payload, binned.chunk_start, binned.nchunks)
    got = cuda_core.raster_probe(*lay, WIDTH, HEIGHT, cfg)
    plain = plain_core.raster_probe_plain(*lay, cfg)
    torch.cuda.synchronize()
    # the kernel sums in float32 in another order: per tile, 1e-5 of the
    # tile's sum of |row 0| over its chunks, plus 1e-5
    abs_sum = plain_core.raster_probe_plain(binned.payload.abs(), *lay[1:], cfg)[:, 0, 0]
    err = (got - plain).abs().amax(dim=(1, 2))
    has = binned.nchunks > 0
    require(bool((err <= 1e-5 * (abs_sum + 1.0)).all()),
            f"probe kernel: error beyond 1e-5 x (sum|row 0| + 1): max err "
            f"{float(err.max())}")
    require(bool((got[has] != 0).all()), "probe kernel: zero output on a tile with chunks")
    require(bool((got[~has] == 0).all()), "probe kernel: non-zero output on an empty tile")
    plain_ms = cuda_ms(lambda: plain_core.raster_probe_plain(*lay, cfg), REPS)

    loader.reset_launch_counts()
    res = measure(binned, WIDTH, HEIGHT, cfg, reps=REPS)
    torch.cuda.synchronize()
    launches = loader.launches["raster_probe"]
    require(launches > 0, "profiling path: the probe kernel was not launched")
    used_chunks = int(binned.nchunks.sum())
    # FP32 operations: the chunk's 255 shuffle adds, then per pixel the
    # ch / 32 partials and 16 accumulator adds
    ops = used_chunks * (cfg.chunk + cfg.tile_pix * (cfg.chunk // 32 + 16))
    b_ms, b_by = bound_ms(nbytes, ops)
    kernels["raster_probe"].update(launches=launches, max_abs_err=float(err.max()),
                                   ms=res["probe_ms"], plain_ms=plain_ms,
                                   bound_ms=b_ms, bound_by=b_by)
    return {"phase": "kernel_probe", "max_abs_err": float(err.max()),
            "max_tile_abs_sum": float(abs_sum.max()), "tiles_with_chunks": int(has.sum()),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "launches": dict(loader.launches), **res}


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
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussianhaircut_torch.ops.rasterize import cuda_core
    from gaussianhaircut_torch.ops.rasterize.api import segment_sum
    from gaussianhaircut_torch.tools.profile_fixed import binned_inputs, cuda_ms
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
    loader.reset_launch_counts()
    state = stage1.train(model_cfg, opt_cfg, pipe_cfg, scene, device=dev,
                         progress_callback=progress)
    torch.cuda.synchronize()
    launches = dict(loader.launches)
    totals = torch.stack(totals).cpu().numpy()
    require(bool(np.isfinite(totals).all()), "train: non-finite loss")
    require(bool(torch.stack(oks).all()), "train: a step had non-finite gradients")
    for name in ("raster_fwd", "raster_bwd"):
        require(launches[name] == iters,
                f"train: {name} launched {launches[name]} times in {iters} steps")
        kernels[name]["launches"] = launches[name]
    # the precompute: one forward and one backward per step, and the camera's
    # gradient summed once per step (its residuals are trainable)
    pre = {k: launches[f"precompute_{k}"] for k in ("fwd", "bwd", "cam_reduce")}
    require(all(v == iters for v in pre.values()),
            f"train: the precompute's kernels launched {pre} times in {iters} steps")
    kernels["precompute"]["launches"] = pre
    densified = [it for it in range(2 * window, iters + 1, window)]
    require(any(alive[it] != alive[it - 1] for it in densified),
            f"train: num_alive never changed at densify ({alive})")
    rates = [window / (marks[b] - marks[a])
             for a, b in zip(sorted(marks)[:-1], sorted(marks)[1:])]
    its = statistics.median(rates)
    step_ms = 1e3 / its

    # per-step split at the final state's shapes (camera 0, SH degree 0 as
    # the trainer uses before iteration 1000)
    binned, binning = binned_inputs(state.model.params, state.model.aux.alive,
                                    0, scene, 0, cfg, dev)
    lay = (binned.payload, binned.chunk_start, binned.nchunks)
    tile_buf = cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg)
    gbuf = seeded_cotangent(torch, cfg, dev)
    dpay = cuda_core.raster_bwd(*lay, tile_buf, gbuf, WIDTH, HEIGHT, cfg)
    split = {
        "binning_ms": cuda_ms(binning, REPS),
        "forward_kernel_ms": cuda_ms(lambda: cuda_core.raster_fwd(
            *lay, WIDTH, HEIGHT, cfg), REPS),
        "backward_kernel_ms": cuda_ms(lambda: cuda_core.raster_bwd(
            *lay, tile_buf, gbuf, WIDTH, HEIGHT, cfg), REPS),
        "segment_reduction_ms": cuda_ms(lambda: segment_sum(dpay, binned), REPS),
    }
    split["rest_ms"] = step_ms - sum(split.values())
    return {"phase": "train", "iterations": iters, "it_per_s_median": its,
            "it_per_s_windows": rates, "it_per_s_min": min(rates),
            "it_per_s_max": max(rates), "step_ms": step_ms, "split": split,
            "small_input_max_err": small_errs,
            "loss_first": float(totals[0]), "loss_last": float(totals[-1]),
            "num_alive": {str(k): v for k, v in sorted(alive.items())},
            "num_rendered_final": binned.num_rendered,
            "cull_final": cull_stats(binned, WIDTH, HEIGHT, cfg)[0], "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def cli_phase(torch, root):
    """The stage-1 CLIs on the bench scene written to disk under ``root``:
    train 60 iterations (evaluation at 30 and 60, PLY at 60, checkpoint and
    camera pickles at 30) into ``root/model``, resume from the checkpoint to
    40 in a second model directory, and render the first model.  it/s is the
    median over the 10-step windows of the metrics log's timestamps (each
    logged step syncs the card)."""
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.cli import render_gaussians, train_gaussians
    from gaussianhaircut_torch.config import ModelConfig
    from gaussianhaircut_torch.scene import ply
    from gaussianhaircut_torch.scene.dataset import load_scene
    from gaussianhaircut_torch.scene.synthetic import bench_scene, write_colmap_scene

    iters, n_evals = 60, 2
    eval_views = 5            # train() scores 5 sampled train views per test
    src, m1, m2 = (os.path.join(root, d) for d in ("scene", "model", "resumed"))
    t0 = time.perf_counter()
    write_colmap_scene(bench_scene(P, WIDTH, HEIGHT, N_VIEWS, SEED), src)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_scene(ModelConfig(source_path=src))
    load_s = time.perf_counter() - t0
    require(len(loaded.train_cameras) == N_VIEWS
            and loaded.train_cameras[0].image.shape == (3, HEIGHT, WIDTH),
            "cli: the written scene does not load back at its size")
    del loaded
    common = ["-s", src, "--sh_degree", "3", "--lambda_dorient", "0.1",
              "--tile", "32", "--densify_from_iter", "10",
              "--densification_interval", "10", "--opacity_reset_interval", "30"]

    torch.cuda.reset_peak_memory_stats()
    loader.reset_launch_counts()
    state = train_gaussians.main(common + [
        "-m", m1, "--iterations", str(iters), "--test_iterations", "30", "60",
        "--save_iterations", "60", "--checkpoint_iterations", "30"])
    torch.cuda.synchronize()
    train_launches = dict(loader.launches)
    require(train_launches["raster_bwd"] == iters,
            f"cli: raster_bwd launched {train_launches['raster_bwd']} times in {iters} steps")
    require(train_launches["raster_fwd"] == iters + n_evals * eval_views,
            f"cli: raster_fwd launched {train_launches['raster_fwd']} times, expected "
            f"{iters} steps + {n_evals * eval_views} evaluation renders")
    recs = _metrics(m1)
    evals = {r["step"]: r for r in recs if "train_psnr" in r}
    require(sorted(evals) == [30, 60], f"cli: evaluations at {sorted(evals)}")
    for r in evals.values():
        require(all(np.isfinite(r[k]) for k in ("train_l1", "train_ce", "train_or",
                                               "train_psnr")), f"cli: eval {r}")
    rates = _window_rates(recs)
    n_alive = state.model.num_alive()
    n_ply = len(ply.read_ply(os.path.join(
        m1, "point_cloud", f"iteration_{iters}", "point_cloud.ply"))["vertex"])
    require(n_ply == n_alive, f"cli: PLY holds {n_ply} rows, num_alive {n_alive}")
    for f in ("checkpoints/30.npz", "cameras/30.pkl", "cameras/30_matrices.pkl",
              "cfg_args.json", f"point_cloud/iteration_{iters}/raw_point_cloud.ply"):
        require(os.path.exists(os.path.join(m1, f)), f"cli: {f} not written")

    loader.reset_launch_counts()
    resumed = train_gaussians.main(common + [
        "-m", m2, "--iterations", "40",
        "--start_checkpoint", os.path.join(m1, "checkpoints", "30.npz")])
    torch.cuda.synchronize()
    resume_launches = dict(loader.launches)
    require(resumed.step == 40 and resume_launches["raster_bwd"] == 10
            and resume_launches["raster_fwd"] == 10,
            f"cli: resume from 30 to 40 launched {resume_launches}")

    loader.reset_launch_counts()
    t0 = time.perf_counter()
    render_gaussians.main(["-s", src, "-m", m1, "--sh_degree", "3"])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    render_launches = dict(loader.launches)
    require(render_launches["raster_fwd"] == N_VIEWS
            and render_launches["raster_bwd"] == 0,
            f"cli: render of {N_VIEWS} views launched {render_launches}")
    out = os.path.join(m1, "train", f"ours_{iters}")
    kinds = sorted(os.listdir(out))
    names = {os.path.splitext(f)[0] for k in kinds for f in os.listdir(os.path.join(out, k))}
    n_files = sum(len(os.listdir(os.path.join(out, k))) for k in kinds)
    require(len(kinds) == 7 and len(names) == N_VIEWS and n_files == 7 * N_VIEWS,
            f"cli: export holds {n_files} files in {kinds} for {len(names)} views")
    return {"phase": "cli", "scene_write_s": write_s, "scene_load_s": load_s,
            "iterations": iters, "it_per_s_median": statistics.median(rates),
            "it_per_s_windows": rates, "eval": {str(k): v for k, v in evals.items()},
            "num_alive": n_alive, "ply_rows": n_ply,
            "render_export_s_per_view": render_s / N_VIEWS,
            "launches": {"train": train_launches, "resume": resume_launches,
                         "render": render_launches},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _start_pair(script: str, log: str) -> list:
    """Two ranks of an inline script (rendezvous on a free localhost port),
    their output into ``log``.<rank>."""
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=port, RANK=str(r),
                   LOCAL_RANK=str(r), WORLD_SIZE="2")
        with open(f"{log}.{r}", "w") as out:
            procs.append(subprocess.Popen([sys.executable, "-c", script], env=env,
                                          stdout=out, stderr=subprocess.STDOUT))
    return procs


def _finish_pair(procs, log: str, timeout: float) -> dict:
    """Exit codes (None: killed at ``timeout``) and of each rank's output
    the first line that names an error, else the last line."""
    t_end = time.perf_counter() + timeout
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(0.0, t_end - time.perf_counter())))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rcs.append(None)
    picked = []
    for r in range(len(procs)):
        with open(f"{log}.{r}") as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        errors = [ln for ln in lines if "Error" in ln]
        picked.append((errors[0] if errors else lines[-1] if lines else "")[:300])
    return {"rcs": rcs, "lines": picked}


def _torchrun(n: int, args: list, timeout: float) -> str:
    """``python -m torch.distributed.run`` with n ranks on this host; raises
    unless it exits 0.  Returns its standard output."""
    env = dict(os.environ, PYTHONPATH=HERE)
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          f"--nproc_per_node={n}", *args], capture_output=True, text=True,
                         env=env, cwd=HERE, timeout=timeout)
    require(res.returncode == 0, f"torch.distributed.run {' '.join(args[:3])} exited "
            f"{res.returncode}:\n{res.stdout[-3000:]}\n{res.stderr[-4000:]}")
    return res.stdout


def hold_mesh_step(got, got_metrics: dict, want, want_metrics: dict, what: str) -> dict:
    """A mesh step's state and metrics against a single-card oracle at
    tests/test_parallel.py's tolerances -> the largest error of each
    quantity."""
    import torch
    errs = {}

    def hold(name, a, b, key):
        rtol, atol = MESH_TOL[key]
        a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
        beyond = (a - b).abs() > atol + rtol * b.abs()
        errs[name] = float((a - b).abs().max())
        require(not bool(beyond.any()), f"{what}: {name} beyond rtol {rtol} / atol {atol} "
                f"of the oracle in {int(beyond.sum())} of {b.numel()} entries (max error "
                f"{errs[name]})")

    for k in ("l1", "ssim", "mask", "orient", "total"):
        hold(k, float(got_metrics[k]), float(want_metrics[k]), "metrics")
    for k in ("xyz", "opacity", "scaling", "features_dc"):
        hold(k, getattr(got.model.params, k), getattr(want.model.params, k), "params")
    for k in ("rotation", "translation", "fov"):
        hold("cam_res." + k, getattr(got.cam_res, k), getattr(want.cam_res, k), "cam_res")
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        hold(k, getattr(got.model.aux, k), getattr(want.model.aux, k), k)
    require(torch.equal(got.cam_opt.count.cpu(), want.cam_opt.count.cpu()),
            f"{what}: camera Adam counts differ")
    require(torch.equal(got.model.aux.alive.cpu(), want.model.aux.alive.cpu()),
            f"{what}: alive masks differ")
    return errs


def averaged_oracle(torch, state, cb, gt, cams, kw):
    """The camera-parallel step computed in one process: each camera's
    ``train_step`` gradients (``stage1.step_grads``), averaged by hand, the
    densify statistics summed and maxed, then ``stage1.apply_grads``."""
    from gaussianhaircut_torch.models.gaussian_model import GaussianAux, GaussianParams
    from gaussianhaircut_torch.render.renderer import default_background, render
    from gaussianhaircut_torch.scene.cameras import CameraResiduals, camera_geom
    from gaussianhaircut_torch.train import stage1
    bg = default_background(False, state.model.params.xyz.device)
    per_cam = []
    for i in cams:
        def forward(params, cam_res, i=i):
            cam = camera_geom(cb.colmap_transform[i], cb.fovx[i], cb.fovy[i], WIDTH, HEIGHT,
                              cam_res, i, use_barf=True, trainable_cameras=True,
                              trainable_intrinsics=True)
            out = render(params, state.model.aux.alive, kw["active_sh_degree"], cam, bg,
                         kw["raster_cfg"])
            loss, parts = stage1.compute_losses(out, gt.image[i], gt.mask[i],
                                                gt.orient_angle[i], gt.orient_conf[i],
                                                kw["opt_cfg"])
            return loss, (parts, out)
        per_cam.append(stage1.step_grads(state, forward))
    n = len(cams)
    gparams = GaussianParams(*(sum(vals) / n for vals in zip(*(g.values() for g, _, _ in per_cam))))
    gcam = CameraResiduals(*(sum(vals) for vals in zip(*(c.values() for _, c, _ in per_cam))))
    gn, vis_count, radii = 0.0, 0.0, torch.zeros_like(state.model.aux.max_radii2d)
    for g, _, (_, out) in per_cam:
        vis = out["visibility_filter"]
        norm = torch.linalg.norm(stage1.safe_viewspace(g)[:, :2], dim=-1)
        gn = gn + torch.where(vis, norm, torch.zeros_like(norm))
        vis_count = vis_count + vis.to(torch.float32)
        radii = torch.maximum(radii, out["radii"].to(torch.float32))
    aux = state.model.aux
    new_aux = GaussianAux(aux.alive, torch.maximum(aux.max_radii2d, radii),
                          aux.xyz_grad_accum + gn, aux.denom + vis_count)
    drawn = torch.zeros(len(state.cam_opt.count), device=gn.device)
    drawn[cams] = 1.0
    new_state, _ = stage1.apply_grads(state, gparams, gcam, new_aux, drawn,
                                      opt_cfg=kw["opt_cfg"], trainable_cameras=True,
                                      trainable_intrinsics=True)
    metrics = {k: sum(p[k].detach() for _, _, (p, _) in per_cam) / n for k in per_cam[0][2][0]}
    return new_state, metrics


def mesh_phase(torch, root):
    """The multi-device step on this card (module doc, phase mesh), from the
    cli phase's scene (``root/scene``) and iteration-30 checkpoint."""
    import shutil
    import torch.distributed as dist
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.cli import render_gaussians
    from gaussianhaircut_torch.config import ModelConfig
    from gaussianhaircut_torch.parallel import tile_parallel
    from gaussianhaircut_torch.parallel import mesh as mesh_mod
    from gaussianhaircut_torch.render.renderer import default_background, render
    from gaussianhaircut_torch.scene import ply
    from gaussianhaircut_torch.scene.cameras import CameraBatch, camera_geom
    from gaussianhaircut_torch.scene.dataset import load_scene
    from gaussianhaircut_torch.tools import mesh_check
    from gaussianhaircut_torch.tools.profile_fixed import nvidia_smi
    from gaussianhaircut_torch.train import stage1

    t_phase = time.perf_counter()
    src = os.path.join(root, "scene")
    ckpt = os.path.join(root, "model", "checkpoints", "30.npz")
    work = os.path.join(root, "mesh")
    os.makedirs(work)
    nccl_probe = _start_pair(NCCL_PROBE, os.path.join(work, "nccl"))
    gloo_probe = _start_pair(GLOO_PROBE, os.path.join(work, "gloo"))

    dev = torch.device("cuda", 0)
    scene = load_scene(ModelConfig(source_path=src))
    cb = CameraBatch.from_cameras(scene.train_cameras, dev)
    gt = stage1.GtBatch.from_cameras(scene.train_cameras, dev)
    del scene
    batch = os.path.join(work, "batch.npz")
    mesh_check.save_batch(batch, cb, gt)
    kw = mesh_check.step_kwargs(WIDTH, HEIGHT)
    state = stage1.load_checkpoint(ckpt, dev)
    out = {"phase": "mesh", "nvidia_smi": nvidia_smi(), "runs": {}}
    launches = {"raster_fwd": {}, "raster_bwd": {}}

    # (a) 1x1 under NCCL in this process against train_step
    ref, ref_m = stage1.train_step(state, cb, gt, 0, **kw)
    mesh_mod.init_distributed(dev, store=dist.HashStore(), rank=0, world_size=1)
    mesh = mesh_mod.make_mesh2d(1, 1, dev)
    loader.reset_launch_counts()
    one, one_m = tile_parallel.dp_tp_train_step(mesh, **kw)(state, cb, gt, [0])
    torch.cuda.synchronize()
    for k in launches:
        launches[k]["1x1"] = loader.launches[k]
    backend = mesh.backend
    dist.destroy_process_group()
    want, got = stage1.checkpoint_arrays(ref), stage1.checkpoint_arrays(one)
    differ = sorted(k for k in want if not np.array_equal(want[k], got[k]))
    require(not differ, f"mesh 1x1 ({backend}): differs from train_step in {differ}")
    require(all(torch.equal(one_m[k], ref_m[k]) for k in ("l1", "ssim", "mask", "orient",
                                                          "total")),
            "mesh 1x1: metrics differ from train_step's")
    require(launches["raster_fwd"]["1x1"] == 1 and launches["raster_bwd"]["1x1"] == 1,
            f"mesh 1x1: launched {launches}")
    # the single-card step from the same state and camera, timed as
    # mesh_check times the mesh steps (host clock around a synchronized step)
    single_ms = []
    for _ in range(mesh_check.REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage1.train_step(state, cb, gt, 0, **kw)
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3)
    out["runs"]["1x1"] = {"backend": backend, "equal_to_train_step": True,
                          "num_rendered": one_m["num_rendered"],
                          "train_step_ms": statistics.median(single_ms)}
    # the kernels' row window (row0 > 0) on the card: the 1x2, 1x4 and 1x8
    # windows of camera 0 are the single render's rows bit for bit
    cam = camera_geom(cb.colmap_transform[0], cb.fovx[0], cb.fovy[0], WIDTH, HEIGHT,
                      state.cam_res, 0, use_barf=True)
    bg = default_background(False, dev)
    params, alive = state.model.params, state.model.aux.alive
    with torch.no_grad():
        whole = render(params, alive, 3, cam, bg, kw["raster_cfg"])["render10"]
        for n_tile in (2, 4, 8):
            crop_h, windows = tile_parallel.row_windows(HEIGHT, 32, n_tile)
            for y0, rows in windows:
                win = tile_parallel.render_window(params, alive, 3, cam, bg, kw["raster_cfg"],
                                                  y0, rows, crop_h, HEIGHT)[0]
                require(torch.equal(win[:, :rows], whole[:, y0:y0 + rows]),
                        f"mesh: the 1x{n_tile} window at row {y0} differs from the render")
    out["windows_equal_render"] = [2, 4, 8]
    del whole, win

    # (b) two ranks under gloo: 1x2 against the single-card step, 2x1
    # against both cameras' gradients averaged here
    steps_dir = os.path.join(work, "steps")
    _torchrun(2, ["-m", "gaussianhaircut_torch.tools.mesh_check", "--batch", batch,
                  "--checkpoint", ckpt, "--mesh", "1x2:0", "--mesh", "2x1:0,1",
                  "--out", steps_dir, "--device", "cuda:0"], timeout=300)
    oracle, oracle_m = averaged_oracle(torch, state, cb, gt, [0, 1], kw)
    for spec, want_state, want_m in (("1x2", ref, ref_m), ("2x1", oracle, oracle_m)):
        ranks = [dict(np.load(os.path.join(steps_dir, spec, f"rank{r}.npz"))) for r in range(2)]
        differ = sorted(k for k in ranks[0] if not np.array_equal(ranks[0][k], ranks[1][k]))
        require(not differ, f"mesh {spec}: rank 1 differs from rank 0 in {differ}")
        recs = []
        for r in range(2):
            with open(os.path.join(steps_dir, spec, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        got = stage1.state_from_arrays(ranks[0], dev)
        errs = hold_mesh_step(got, recs[0]["metrics"], want_state, want_m, f"mesh {spec}")
        for k in launches:
            launches[k][spec] = [rec["launches"][k] for rec in recs]
            require(launches[k][spec] == [1, 1], f"mesh {spec}: {k} launched {launches[k][spec]}")
        out["runs"][spec] = {
            "backend": recs[0]["backend"], "max_err": errs, "ranks_identical": True,
            "step_ms": [rec["step_ms"] for rec in recs],
            "collective_ms": [rec["collective_ms"] for rec in recs],
            "bytes_per_step": [rec["bytes_per_step"] for rec in recs],
            "collective_calls": [rec["collective_calls"] for rec in recs],
            "num_rendered": [rec["metrics"]["num_rendered"] for rec in recs]}
    del oracle, ref, one

    # (c) the CLI on a 2x2 mesh, four ranks, from an empty build directory
    # (the libraries this process loaded are set aside and put back, also
    # when the run fails, so that a later run starts from the same tree)
    aside = loader.BUILD_DIR + ".before_mesh"
    shutil.rmtree(aside, ignore_errors=True)
    os.rename(loader.BUILD_DIR, aside)
    model = os.path.join(work, "model")
    t0 = time.perf_counter()
    try:
        stdout = _torchrun(4, [
            "-m", "gaussianhaircut_torch.cli.train_gaussians", "--mesh", "2x2",
            "--device", "cuda:0", "-s", src, "-m", model, "--sh_degree", "3",
            "--lambda_dorient", "0.1", "--tile", "32", "--iterations", str(MESH_ITERS),
            "--densify_from_iter", "10", "--densification_interval", "10",
            "--densify_until_iter", str(MESH_DENSIFY + 1),
            "--test_iterations", str(MESH_ITERS), "--save_iterations", str(MESH_ITERS),
            "--checkpoint_iterations", str(MESH_ITERS)], timeout=400)
        cli_s = time.perf_counter() - t0
        built = sorted(os.listdir(loader.BUILD_DIR))
    finally:
        shutil.rmtree(loader.BUILD_DIR, ignore_errors=True)
        os.rename(aside, loader.BUILD_DIR)
    require(built == sorted(os.path.basename(loader._lib_path(n))
                            for n in loader.SOURCES),
            f"mesh: the ranks' build left {built}")
    summary = [ln for ln in stdout.splitlines() if ln.startswith("mesh_summary ")]
    require(len(summary) == 1, f"mesh 2x2: {len(summary)} summary lines")
    summary = json.loads(summary[0].split(" ", 1)[1])
    ranks = summary["ranks"]
    for k in launches:
        launches[k]["2x2"] = [r["launches"][k] for r in ranks]
    eval_views = 5            # train() scores 5 sampled train views per test
    require(launches["raster_bwd"]["2x2"] == [MESH_ITERS] * 4
            and launches["raster_fwd"]["2x2"] == [MESH_ITERS + eval_views] + [MESH_ITERS] * 3,
            f"mesh 2x2: launched {launches}")
    recs = _metrics(model)
    totals = [r["total"] for r in recs if "total" in r]
    require(len(totals) == MESH_ITERS // 10 and bool(np.isfinite(totals).all()),
            f"mesh 2x2: logged losses {totals}")
    alive = {r["step"]: r["num_alive"] for r in recs if "num_alive" in r}
    require(alive[MESH_DENSIFY] != alive[MESH_DENSIFY - 10],
            f"mesh 2x2: num_alive did not change at the densification ({alive})")
    final = stage1.load_checkpoint(os.path.join(model, "checkpoints", f"{MESH_ITERS}.npz"), dev)
    n_ply = len(ply.read_ply(os.path.join(model, "point_cloud", f"iteration_{MESH_ITERS}",
                                          "point_cloud.ply"))["vertex"])
    require(final.step == MESH_ITERS and n_ply == final.model.num_alive(),
            f"mesh 2x2: checkpoint step {final.step}, PLY rows {n_ply}")
    require(stage1.state_digest(final) == summary["state_sha256"],
            "mesh 2x2: rank 0's checkpoint is not the state the ranks agreed on")
    loader.reset_launch_counts()
    render_gaussians.main(["-s", src, "-m", model, "--sh_degree", "3"])
    torch.cuda.synchronize()
    require(loader.launches["raster_fwd"] == N_VIEWS,
            f"mesh: render_gaussians of rank 0's model launched {dict(loader.launches)}")
    out["runs"]["2x2"] = {
        "backend": summary["backend"], "cli_s": cli_s, "state_sha256": summary["state_sha256"],
        "step_ms": [r["step_ms"] for r in ranks],
        "collective_ms_per_step": [r["collective_ms_per_step"] for r in ranks],
        "bytes_per_step": [r["bytes_per_step"] for r in ranks],
        "losses": totals, "num_alive": alive, "eval_psnr": [r["train_psnr"] for r in recs
                                                            if "train_psnr" in r],
        "built_from_empty": built}

    out["nccl_two_ranks_one_card"] = _finish_pair(nccl_probe, os.path.join(work, "nccl"), 60)
    gloo = _finish_pair(gloo_probe, os.path.join(work, "gloo"), 60)
    with open(os.path.join(work, "gloo.0")) as f:
        found = [ln for ln in f.read().splitlines() if ln.startswith("GLOO_CUDA ")]
    require(gloo["rcs"] == [0, 0] and len(found) == 1, f"mesh: the gloo probe failed: {gloo}")
    ops = json.loads(found[0].split(" ", 1)[1])
    refused = sorted(op for op, res in ops.items() if res != "ok")
    require(not refused, f"mesh: gloo refuses CUDA tensors in {refused}, which "
            f"parallel/collectives.py hands it as they are ({ops})")
    out["gloo_cuda_ops"] = ops
    out["launches_mesh"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def hold_close(got, want, what: str, rtol: float, atol_frac: float) -> dict:
    """|got - want| <= atol_frac * max|want| + rtol * |want| -> the max
    error, max |want| and whether the two are bit-equal."""
    import torch
    scale = float(want.abs().max())
    err = (got - want).abs()
    excess = float((err - (atol_frac * scale + rtol * want.abs())).max())
    require(excess <= 0, f"{what}: beyond rtol {rtol} / atol {atol_frac} x max|want| (max|want| "
            f"{scale}, max err {float(err.max())})")
    return {"max_abs_err": float(err.max()), "max_abs": scale,
            "bit_equal": bool(torch.equal(got, want))}


def batched_phase(torch, root, cfg, kernels):
    """The batched-camera step (module doc, phase batched), from the cli
    phase's scene (``root/scene``) and iteration-30 checkpoint."""
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussianhaircut_torch.ops.rasterize import common as C
    from gaussianhaircut_torch.ops.rasterize import cuda_core, plain_core
    from gaussianhaircut_torch.ops.rasterize.api import (
        ndc_xy_to_pixel, rasterize, rasterize_batched)
    from gaussianhaircut_torch.render.renderer import (
        default_background, fields_from_params, prepare_raster_inputs, render_fields,
        render_fields_batched)
    from gaussianhaircut_torch.scene.cameras import CameraBatch, camera_geom
    from gaussianhaircut_torch.scene.dataset import load_scene
    from gaussianhaircut_torch.tools import mesh_check
    from gaussianhaircut_torch.tools.profile_fixed import cuda_ms, nvidia_smi
    from gaussianhaircut_torch.train import stage1

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    scene = load_scene(ModelConfig(source_path=os.path.join(root, "scene")))
    cb = CameraBatch.from_cameras(scene.train_cameras, dev)
    gt = stage1.GtBatch.from_cameras(scene.train_cameras, dev)
    kw = mesh_check.step_kwargs(WIDTH, HEIGHT)
    sh = kw["active_sh_degree"]
    state = stage1.load_checkpoint(os.path.join(root, "model", "checkpoints", "30.npz"), dev)
    params, alive = state.model.params, state.model.aux.alive
    bg = default_background(False, dev)
    views = list(range(N_VIEWS))
    geoms = [camera_geom(cb.colmap_transform[i], cb.fovx[i], cb.fovy[i], WIDTH, HEIGHT,
                         state.cam_res, i, use_barf=True) for i in views]
    out = {"phase": "batched", "nvidia_smi": nvidia_smi(), "slots": state.model.capacity,
           "num_alive": state.model.num_alive()}

    # (a) one batched render of the four views against four single renders
    with torch.no_grad():
        fields = fields_from_params(params, alive)
        inputs = [prepare_raster_inputs(fields, sh, g) for g in geoms]
        stacked = [torch.stack(x) for x in zip(*inputs)]
        loader.reset_launch_counts()
        batch = rasterize_batched(*stacked, bg, WIDTH, HEIGHT, cfg)
        require(loader.launches["raster_fwd"] == 1,
                f"batched: rasterize_batched of {N_VIEWS} views launched {loader.launches}")
        singles = [rasterize(*x, bg, WIDTH, HEIGHT, cfg) for x in inputs]
    for k in ("render", "final_T", "radii", "visibility"):
        for b, one in enumerate(singles):
            require(torch.equal(batch[k][b], one[k]),
                    f"batched: view {b}'s {k} differs from its single render")
    per_view = [one["num_rendered"] for one in singles]
    require(batch["num_rendered"] == sum(per_view)
            and batch["num_rendered_bound"] == N_VIEWS * max(per_view),
            f"batched: num_rendered {batch['num_rendered']} / bound "
            f"{batch['num_rendered_bound']} for views {per_view}")
    out["render_b4"] = {"equal_to_single_renders": True, "num_rendered": batch["num_rendered"],
                        "num_rendered_per_view": per_view}
    del batch, singles

    # (b) both kernels on the four views' grid against their plain versions
    def binned(sel):
        ndc, conic, colors, opacity, depth, valid = (x[sel].reshape((-1,) + tuple(x.shape[2:]))
                                                     for x in stacked)
        mean_pix = ndc_xy_to_pixel(ndc, WIDTH, HEIGHT)
        pre = C.preprocess(mean_pix, conic, depth, valid, WIDTH, HEIGHT, cfg, opacity=opacity)
        return C.bin_instances(pre, mean_pix, conic, opacity, colors, depth, WIDTH, HEIGHT,
                               cfg, n_batch=len(sel))

    gy = cfg.grid(WIDTH, HEIGHT)[1]
    b4 = binned(views)
    lay = (b4.payload, b4.chunk_start, b4.nchunks)
    card_masks = cuda_core.warp_masks(*lay, WIDTH, HEIGHT, cfg)
    masks = plain_core.warp_masks_plain(*lay, WIDTH, cfg, grid_y=gy)
    require(torch.equal(card_masks, masks), f"batched: {int((card_masks != masks).sum())} of "
            "the card's warp masks differ from the plain mirror's on the four-view grid")
    stats = {}
    plain_buf = plain_core.raster_fwd_plain(*lay, WIDTH, HEIGHT, cfg, stats=stats, masks=masks)
    tile_buf = cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg)
    require(torch.equal(tile_buf, plain_buf),
            "batched: the forward kernel on the four-view grid is not its plain version's "
            f"bit for bit (max err {float((tile_buf - plain_buf).abs().max())})")
    del plain_buf
    gbuf = seeded_cotangent(torch, cfg, dev, N_VIEWS)
    bargs = (*lay, tile_buf, gbuf, WIDTH, HEIGHT, cfg)
    d1 = cuda_core.raster_bwd(*bargs)
    require(bool(torch.isfinite(d1).all()) and torch.equal(d1, cuda_core.raster_bwd(*bargs)),
            "batched: the backward kernel on the four-view grid is non-finite or differs "
            "between two runs")
    b2 = binned(views[:2])
    lay2 = (b2.payload, b2.chunk_start, b2.nchunks)
    buf2 = cuda_core.raster_fwd(*lay2, WIDTH, HEIGHT, cfg)
    require(torch.equal(buf2, plain_core.raster_fwd_plain(*lay2, WIDTH, HEIGHT, cfg)),
            "batched: the forward kernel at two views is not its plain version's")
    bargs2 = (*lay2, buf2, seeded_cotangent(torch, cfg, dev, 2), WIDTH, HEIGHT, cfg)
    rows = hold_dpay(cuda_core.raster_bwd(*bargs2), plain_core.raster_bwd_plain(*bargs2))
    # the two kernels' times on the four-view grid, and their bounds for
    # the pairs this grid's data needs (the kernel phases' counting)
    used_chunks = int(b4.nchunks.sum())
    in_bytes = used_chunks * 16 * cfg.chunk * 4 + 2 * b4.num_tiles * 4
    buf_bytes = b4.num_tiles * cfg.tile_pix * C.PAD_CHANNELS * 4
    grid_b4 = {}
    for name, fn, nbytes, blend in (
            ("raster_fwd", lambda: cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg),
             in_bytes + buf_bytes, OPS_BLEND_FWD),
            ("raster_bwd", lambda: cuda_core.raster_bwd(*bargs),
             in_bytes + 2 * buf_bytes + used_chunks * C.GRAD_ROWS * cfg.chunk * 4,
             OPS_BLEND_BWD)):
        b_ms, b_by = bound_ms(nbytes, stats["kept"] * OPS_VISIT + stats["contrib"] * blend)
        grid_b4[name] = {"ms": cuda_ms(fn, REPS), "bound_ms": b_ms, "bound_by": b_by}
        kernels[name]["batched_b4"] = grid_b4[name]
    # the same work as four launches, one per view's own grid
    singles_ms = {"raster_fwd": 0.0, "raster_bwd": 0.0}
    for i in views:
        one = binned([i])
        lay1 = (one.payload, one.chunk_start, one.nchunks)
        buf1 = cuda_core.raster_fwd(*lay1, WIDTH, HEIGHT, cfg)
        g1 = gbuf[i * b4.num_tiles // N_VIEWS:(i + 1) * b4.num_tiles // N_VIEWS]
        singles_ms["raster_fwd"] += cuda_ms(
            lambda: cuda_core.raster_fwd(*lay1, WIDTH, HEIGHT, cfg), REPS)
        singles_ms["raster_bwd"] += cuda_ms(
            lambda: cuda_core.raster_bwd(*lay1, buf1, g1, WIDTH, HEIGHT, cfg), REPS)
    for name in singles_ms:
        grid_b4[name]["four_single_view_launches_ms"] = singles_ms[name]
    out["kernels_b4"] = {"tiles": b4.num_tiles, "chunks_used": used_chunks,
                         "num_rendered": b4.num_rendered, "pairs_visited_kept": stats["kept"],
                         "pairs_blended": stats["contrib"], "masks_equal": True,
                         "forward_bit_identical": True, "backward_runs_identical": True,
                         "backward_b2_rows": rows, **grid_b4}
    del b4, b2, one, lay, lay2, lay1, bargs, bargs2, tile_buf, buf2, buf1, d1, gbuf, g1
    del masks, card_masks

    # (c) parameter gradients of a seeded cotangent: one batched render
    # against four single renders summed
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    weight = torch.randn((N_VIEWS, 10, HEIGHT, WIDTH), generator=gen, device=dev)
    leaves = params.map(lambda t: t.detach().requires_grad_())
    got = torch.autograd.grad(
        (render_fields_batched(fields_from_params(leaves, alive), sh, geoms, bg, cfg)
         ["render10"] * weight).sum(), leaves.values(), allow_unused=True)
    want = None
    for b, g in enumerate(geoms):
        one = torch.autograd.grad(
            (render_fields(fields_from_params(leaves, alive), sh, g, bg, cfg)["render10"]
             * weight[b]).sum(), leaves.values(), allow_unused=True)
        want = one if want is None else [a if c is None else a + c for a, c in zip(want, one)]
    grads = {}
    for name, a, c in zip(params.names(), got, want):
        require((a is None) == (c is None), f"batched: {name}'s gradient reached one side only")
        if c is not None:
            grads[name] = hold_close(a, c, f"batched: {name}'s gradient", **BATCH_GRAD_TOL)
    out["grads_b4"] = {"tolerance": BATCH_GRAD_TOL, **grads}
    del got, want, leaves

    # (d) the step: B=1 against train_step, B=2 against the oracle
    ref, ref_m = stage1.train_step(state, cb, gt, 0, **kw)
    one, one_m = stage1.train_step_batched(state, cb, gt, [0], **kw)
    require(stage1.state_digest(one) == stage1.state_digest(ref),
            "batched: the B=1 step differs from train_step")
    require(all(torch.equal(one_m[k], ref_m[k]) for k in ("l1", "ssim", "mask", "orient", "total")),
            "batched: the B=1 step's metrics differ from train_step's")
    two, two_m = stage1.train_step_batched(state, cb, gt, [0, 1], **kw)
    oracle, oracle_m = averaged_oracle(torch, state, cb, gt, [0, 1], kw)
    out["step"] = {"b1_equal_to_train_step": True, "state_sha256": stage1.state_digest(one),
                   "b2_max_err": hold_mesh_step(two, two_m, oracle, oracle_m, "batched B=2")}
    del ref, one, two, oracle

    # (f) ms per step from the same state, cameras/s, launches, memory
    timing = {}
    for n in ("train_step",) + BATCH_SIZES:
        step = ((lambda: stage1.train_step(state, cb, gt, 0, **kw)) if n == "train_step" else
                (lambda n=n: stage1.train_step_batched(state, cb, gt, views[:n], **kw)))
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loader.reset_launch_counts()
        _, m = step()
        torch.cuda.synchronize()
        launches = {k: loader.launches[k] for k in ("raster_fwd", "raster_bwd")}
        peak = torch.cuda.max_memory_allocated() / 1e9
        ms = []
        for _ in range(BATCH_REPS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        cams = 1 if n == "train_step" else n
        require(launches == {"raster_fwd": 1, "raster_bwd": 1},
                f"batched: a step at {n} launched {launches}")
        timing[str(n)] = {"ms_median": statistics.median(ms), "ms_min": min(ms),
                          "ms_max": max(ms), "cameras_per_s": cams * 1e3 / statistics.median(ms),
                          "launches_per_step": launches, "num_rendered": m["num_rendered"],
                          "peak_mem_gb": peak}
    out["timing"] = timing

    # (e) the loop: train(camera_batch=2) through one densification
    opt_cfg = OptimizationConfig(iterations=BATCH_ITERS, lambda_dorient=0.1,
                                 densify_from_iter=BATCH_DENSIFY // 2,
                                 densification_interval=BATCH_DENSIFY,
                                 densify_until_iter=BATCH_DENSIFY + 1)
    model_cfg = ModelConfig(sh_degree=3, use_barf=True, trainable_cameras=True,
                            trainable_intrinsics=True)
    totals, alive_at = [], {}

    def progress(it, st, m):
        totals.append(m["total"])
        if it in (BATCH_DENSIFY - 1, BATCH_DENSIFY, BATCH_ITERS):
            alive_at[it] = st.model.num_alive()

    loader.reset_launch_counts()
    t0 = time.perf_counter()
    final = stage1.train(model_cfg, opt_cfg, PipelineConfig(tile=32), scene, device=dev,
                         camera_batch=2, progress_callback=progress, test_iterations=(),
                         save_iterations=(), checkpoint_iterations=())
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {k: loader.launches[k] for k in ("raster_fwd", "raster_bwd")}
    totals = torch.stack(totals).cpu().numpy()
    require(final.step == BATCH_ITERS and bool(np.isfinite(totals).all()),
            f"batched: train(camera_batch=2) ended at step {final.step}, losses {totals}")
    require(launches == {"raster_fwd": BATCH_ITERS, "raster_bwd": BATCH_ITERS},
            f"batched: train(camera_batch=2) launched {launches} in {BATCH_ITERS} steps")
    require(alive_at[BATCH_DENSIFY] != alive_at[BATCH_DENSIFY - 1],
            f"batched: num_alive did not change at the densification ({alive_at})")
    require(int(final.cam_opt.count.sum()) == 2 * BATCH_ITERS,
            f"batched: camera rows stepped {final.cam_opt.count.tolist()}")
    out["loop"] = {"iterations": BATCH_ITERS, "step": final.step, "seconds": loop_s,
                   "num_alive": {str(k): v for k, v in sorted(alive_at.items())},
                   "loss_first": float(totals[0]), "loss_last": float(totals[-1]),
                   "camera_rows_stepped": final.cam_opt.count.tolist(), "launches": launches}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def viewer_phase(torch, scene, dev):
    """The live viewer during ``train()`` at the bench configuration: a
    loopback client connected before training sends one request per
    iteration (VIEWER_ITERS of them, lock-step), a 960x544 camera (bench
    camera 1) at the iterations of VIEWER_ASKS and no camera at the others;
    the last 960x544 request holds the trainer with keep_alive until one
    more request lets it go.  Each reply must equal ``render()`` of the same
    camera on the state the trainer held then (copied by the progress
    callback after the step before); the training must finish.  The round
    trip (request sent to reply read) includes the training step the
    trainer finishes before its poll; ``reply_ms`` times the reply's render
    and copy alone."""
    import socket
    import struct
    import threading
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
    from gaussianhaircut_torch.render import network_gui
    from gaussianhaircut_torch.render.renderer import default_background, render
    from gaussianhaircut_torch.tools.profile_fixed import cuda_ms, scene_camera
    from gaussianhaircut_torch.train import stage1

    geom = scene_camera(scene, 1, dev)
    cam = scene.train_cameras[1]
    view, proj = (m.cpu().numpy() for m in (geom.viewmatrix, geom.projmatrix))
    extra = json.dumps({"fov_x": cam.fovx, "fov_y": cam.fovy}).encode()

    def request(width, height, keep_alive):
        body = struct.pack("IIbbbbf", width, height, 1, 0, 0, keep_alive, 1.0)
        body += view.astype(np.float32).tobytes() + proj.astype(np.float32).tobytes()
        body += struct.pack("I", len(extra)) + extra
        return struct.pack("I", len(body)) + body

    plan = [(WIDTH, HEIGHT) if it in VIEWER_ASKS else (0, 0)
            for it in range(1, VIEWER_ITERS + 1)]
    plan = [(w, h, int(i == VIEWER_ITERS - 1 and w > 0)) for i, (w, h) in enumerate(plan)]
    plan.append((0, 0, 0))                       # lets the held trainer go
    replies, round_trips, errors = [], [], []

    def viewer(sock):
        def exact(n):
            out = b""
            while len(out) < n:
                chunk = sock.recv(n - len(out))
                require(bool(chunk), "viewer: the trainer closed the connection")
                out += chunk
            return out
        try:
            for w, h, keep in plan:
                t0 = time.perf_counter()
                sock.sendall(request(w, h, keep))
                image = exact(w * h * 3)
                src = exact(struct.unpack("<I", exact(4))[0])
                if w:
                    round_trips.append((time.perf_counter() - t0) * 1e3)
                replies.append((image, src))
        except Exception as e:
            errors.append(repr(e))
        finally:
            sock.close()

    states = {}

    def progress(it, st, m):
        if it + 1 in VIEWER_ASKS:
            states[it + 1] = (gm.GaussianParams(*(v.detach().clone()
                                                  for v in st.model.params.values())),
                              st.model.aux.alive.clone())
        losses.append(m["total"])

    losses = []
    network_gui.init("127.0.0.1", 0)
    try:
        sock = socket.create_connection(network_gui.listener.getsockname(), timeout=120)
        sock.settimeout(120)
        thread = threading.Thread(target=viewer, args=(sock,), daemon=True)
        loader.reset_launch_counts()
        t0 = time.perf_counter()
        thread.start()
        state = stage1.train(
            ModelConfig(sh_degree=3, use_barf=True, trainable_cameras=True,
                        trainable_intrinsics=True, source_path="bench"),
            OptimizationConfig(iterations=VIEWER_ITERS, lambda_dorient=0.1),
            PipelineConfig(tile=32), scene, device=dev, progress_callback=progress)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(loader.launches)
        thread.join(120)
    finally:
        if network_gui.conn is not None:
            network_gui.conn.close()
        network_gui.listener.close()
        network_gui.listener = network_gui.conn = None
    require(not thread.is_alive() and not errors, f"viewer: the client failed {errors}")
    require(state.step == VIEWER_ITERS and bool(np.isfinite(
        torch.stack(losses).cpu().numpy()).all()), "viewer: the training did not finish")
    require(len(replies) == len(plan) and all(src == b"bench" for _, src in replies),
            f"viewer: {len(replies)} replies to {len(plan)} requests")
    images = [img for img, _ in replies if img]
    require(len(images) == len(VIEWER_ASKS), f"viewer: {len(images)} images")
    want_launches = {"raster_fwd": VIEWER_ITERS + len(VIEWER_ASKS), "raster_bwd": VIEWER_ITERS}
    require(all(launches[k] == v for k, v in want_launches.items()),
            f"viewer: launched {launches}, expected {want_launches}")
    # each reply against render() of its camera on the state it was rendered from
    custom = dict(width=WIDTH, height=HEIGHT, world_view_transform=view,
                  full_proj_transform=proj, fovx=cam.fovx, fovy=cam.fovy)
    bg = default_background(False, dev)
    rcfg = RasterConfig(tile_w=32, tile_h=32)

    def reply(params, alive):
        with torch.no_grad():
            out = render(params, alive, 0, stage1.gui_camera(custom, dev), bg, rcfg)["render"]
            return (out.clamp(0, 1) * 255).to(torch.uint8).permute(1, 2, 0).contiguous().cpu()

    for it, img in zip(VIEWER_ASKS, images):
        require(img == reply(*states[it]).numpy().tobytes(),
                f"viewer: the reply at iteration {it} differs from render()")
    return {"phase": "viewer", "iterations": VIEWER_ITERS, "requests": len(plan),
            "images": len(images), "size": [WIDTH, HEIGHT], "replies_equal_render": True,
            "round_trip_ms": round_trips, "round_trip_ms_median": statistics.median(round_trips),
            "reply_ms": cuda_ms(lambda: reply(*states[VIEWER_ASKS[-1]]), REPS),
            "train_s": train_s, "launches": launches}


def video_phase(torch, root):
    """``cli.render_video`` on the cli phase's trained model (``root/model``,
    iteration 60) for VIDEO_FRAMES frames: one forward launch per frame;
    frame 0 equal to the plain forward's render of the path's first camera
    (the kernel's tile buffer bit for bit against the plain version's, and
    the PNG's bytes against the plain image's); the AVI's index read back to
    the frames' PNG bytes."""
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.cli import render_video
    from gaussianhaircut_torch.config import ModelConfig
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.ops.rasterize import common as C
    from gaussianhaircut_torch.ops.rasterize import cuda_core, plain_core
    from gaussianhaircut_torch.postprocessing.video import read_avi
    from gaussianhaircut_torch.render.renderer import default_background, fields_from_params
    from gaussianhaircut_torch.scene.cameras import camera_geom
    from gaussianhaircut_torch.scene.dataset import load_scene
    from gaussianhaircut_torch.tools.profile_fixed import binned_fields
    from gaussianhaircut_torch.utils.image import read_png

    src, model = os.path.join(root, "scene"), os.path.join(root, "model")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loader.reset_launch_counts()
    t0 = time.perf_counter()
    render_video.main(["-s", src, "-m", model, "--sh_degree", "3", "--tile", "32",
                       "--num_frames", str(VIDEO_FRAMES)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(loader.launches)
    require(launches["raster_fwd"] == VIDEO_FRAMES and launches["raster_bwd"] == 0,
            f"video: {VIDEO_FRAMES} frames launched {launches}")
    frames_dir = os.path.join(model, "video_frames")
    names = sorted(os.listdir(frames_dir))
    require(len(names) == VIDEO_FRAMES, f"video: {len(names)} frames")
    avi = read_avi(os.path.join(model, "video.avi"))
    require(avi["frames"] == [open(os.path.join(frames_dir, n), "rb").read() for n in names]
            and (avi["width"], avi["height"]) == (WIDTH, HEIGHT),
            "video: the AVI's index does not read back to the frames")

    # frame 0 through the plain forward on the card
    cams = load_scene(ModelConfig(source_path=src), load_gt=False).train_cameras
    w2c = render_video.camera_path(cams, VIDEO_FRAMES)[0]
    dev = torch.device("cuda")
    state = gm.load_ply(os.path.join(model, "point_cloud", "iteration_60",
                                     "raw_point_cloud.ply"), 0, 3, device=dev)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    geom = camera_geom(torch.as_tensor(w2c, device=dev), f32(cams[0].fovx), f32(cams[0].fovy),
                       WIDTH, HEIGHT)
    cfg = C.RasterConfig(tile_w=32, tile_h=32)
    binned, _ = binned_fields(fields_from_params(state.params, state.aux.alive), 3, geom, cfg)
    lay = (binned.payload, binned.chunk_start, binned.nchunks)
    plain = plain_core.raster_fwd_plain(*lay, WIDTH, HEIGHT, cfg)
    card = cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg)
    require(torch.equal(card, plain), "video: frame 0's forward differs from its plain version")
    image, _ = C.assemble_image(plain, default_background(False, dev), WIDTH, HEIGHT, cfg)
    want = (np.clip(image[:3].cpu().numpy().transpose(1, 2, 0), 0, 1) * 255).round()
    require(np.array_equal(read_png(os.path.join(frames_dir, names[0])), want.astype(np.uint8)),
            "video: frame 0 differs from the plain forward's render")
    return {"phase": "video", "frames": VIDEO_FRAMES, "size": [WIDTH, HEIGHT],
            "cli_s": cli_s, "frames_per_s": VIDEO_FRAMES / cli_s,
            "frame0_num_rendered": binned.num_rendered, "frame0_equal_plain": True,
            "avi_bytes": os.path.getsize(os.path.join(model, "video.avi")),
            "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def masks_phase(torch, data, root):
    """``cli.calc_masks`` (the GrabCut fallback) on the MASK_VIEWS of the
    pipeline scene's raw 1920x1088 images: non-empty hair, face and body
    masks with hair and face nearly disjoint (their overlap under 10% of the
    hair, tests/test_masks_fallback.py:62-64); seconds per view, split into
    the min cuts and the rest (both on the card)."""
    import shutil
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.cli import calc_masks
    from gaussianhaircut_torch.utils.image import read_png

    t_phase = time.perf_counter()
    scene = os.path.join(root, "masks_scene")
    os.makedirs(os.path.join(scene, "input"))
    for name in MASK_VIEWS:
        shutil.copy(os.path.join(data, "images", name), os.path.join(scene, "input", name))
    calc_masks.timings.update(min_cut_s=0.0, other_s=0.0)
    loader.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calc_masks.main(["--scene_path", scene, "--images_dir", "input"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    views = {}
    for name in MASK_VIEWS:
        m = {sub: read_png(os.path.join(scene, "masks", sub, name)) > 127
             for sub in ("hair", "face", "body")}
        require(all(v.shape == (PIPE_HEIGHT, PIPE_WIDTH) for v in m.values()),
                f"masks: {name} masks are not {PIPE_WIDTH}x{PIPE_HEIGHT}")
        views[name] = {sub: int(v.sum()) for sub, v in m.items()}
        views[name]["hair_and_face"] = int((m["hair"] & m["face"]).sum())
        require(all(views[name][sub] > 0 for sub in ("hair", "face", "body")),
                f"masks: an empty mask in {name}: {views[name]}")
        require(views[name]["hair_and_face"] < 0.1 * views[name]["hair"],
                f"masks: hair and face overlap in {name}: {views[name]}")
    n = len(MASK_VIEWS)
    return {"phase": "masks", "views": n, "size": [PIPE_WIDTH, PIPE_HEIGHT],
            "pixels": views, "s_per_view": seconds / n,
            "min_cut_s_per_view": calc_masks.timings["min_cut_s"] / n,
            "other_s_per_view": calc_masks.timings["other_s"] / n,
            "launches": dict(loader.launches), "seconds": time.perf_counter() - t_phase}


def _metrics(path: str) -> list:
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _window_rates(recs: list) -> list:
    """it/s over the windows between logged steps (each logged step syncs
    the card)."""
    logged = {r["step"]: r["t"] for r in recs if "total" in r}
    steps = sorted(logged)
    return [(b - a) / (logged[b] - logged[a]) for a, b in zip(steps[:-1], steps[1:])]


def strand_scene(scene, center=(0.0, 0.1, 0.0), radius=0.25):
    """The bench scene with a hair mask of 1 inside the projected disc of
    ``radius`` around the scalp cap (the synthetic scalp pool lies within
    0.1 of (0, 0.05, 0)) and 0 elsewhere: stage 1 then labels the blob's
    Gaussians outside the hair as head, the rows stage 2 composites under
    the strands."""
    for c in scene.train_cameras:
        w2c = np.asarray(c.colmap_transform, np.float64)
        p = w2c[:3, :3] @ np.asarray(center) + w2c[:3, 3]
        fx = c.width / (2 * np.tan(c.fovx / 2))
        fy = c.height / (2 * np.tan(c.fovy / 2))
        u, v = fx * p[0] / p[2] + c.width / 2, fy * p[1] / p[2] + c.height / 2
        yy, xx = np.mgrid[0:c.height, 0:c.width]
        r_pix = radius * fx / p[2]
        c.mask_hair = (((xx - u) ** 2 + ((yy - v) * fx / fy) ** 2 <= r_pix ** 2)
                       .astype(np.float32)[None])
    return scene


def strands_phase(torch, cfg, dev, keep_ckpt=None):
    """The strand stack through its CLIs on the bench scene written to
    disk: a short stage 1, stage 2 at the full-width defaults with the
    self-trained diffusion prior, stage 3 with a fresh SDS prior, and the
    export.  Returns (the phase's record, the final stage-2 layout's
    fields for kernel_strands); the stage-2 checkpoint is moved to
    ``keep_ckpt`` when given."""
    import shutil
    import tempfile
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.cli import (
        export_curves, train_gaussians, train_latent_strands, train_strands)
    from gaussianhaircut_torch.cli.render_gaussians import find_head_ply
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.models.textured_strands import (
        TexturedStrandsConfig, sample_roots, synthetic_scalp_pool)
    from gaussianhaircut_torch.scene.synthetic import bench_scene, write_colmap_scene
    from gaussianhaircut_torch.tools.profile_fixed import binned_fields, scene_camera
    from gaussianhaircut_torch.train import stage2, stage3

    s1_iters, iters = S1_ITERS, STRAND_ITERS
    scene = strand_scene(bench_scene(P, WIDTH, HEIGHT, N_VIEWS, SEED))
    scfg = TexturedStrandsConfig(num_strands=N_STRANDS, texture_size=TEXTURE,
                                 strand_length=STRAND_LEN, diffusion_input=DIFF_INPUT,
                                 sh_degree=3, use_diffusion=True)
    n_strands, length = scfg.num_strands, scfg.strand_length
    cam0 = scene_camera(scene, 0, dev)
    out = {"phase": "strands", "strands": n_strands, "strand_length": length,
           "texture_size": scfg.texture_size, "diffusion_input": scfg.diffusion_input}
    with tempfile.TemporaryDirectory(prefix="ghstrands_") as root:
        src, model, hair = (os.path.join(root, d) for d in ("scene", "model", "hair"))
        curves = os.path.join(root, "curves_reconstruction", "smoke")
        write_colmap_scene(scene, src)
        train_gaussians.main(["-s", src, "-m", model, "--sh_degree", "3",
                              "--iterations", str(s1_iters), "--save_iterations", str(s1_iters),
                              "--checkpoint_iterations", str(s1_iters)])
        head_model = gm.load_ply(find_head_ply(model, s1_iters), 0, 3, device=dev)
        head = stage2.make_head_fields(head_model)
        n_head = head.xyz.shape[0]
        out["head_rows"] = int(head.valid.sum())
        # the pipeline's flags (run_pipeline.py:191-211)
        flags = ["-s", src, "-m", model, "--sh_degree", "3", "--iterations", str(iters),
                 "--checkpoint_iterations", str(iters), "--lambda_dmask", "0.1",
                 "--lambda_dorient", "0.1", "--lambda_dsds", "0.01",
                 "--num_strands", str(N_STRANDS), "--strand_length", str(STRAND_LEN),
                 "--texture_size", str(TEXTURE), "--diffusion_input", str(DIFF_INPUT)]
        pool = synthetic_scalp_pool(scfg.pool_size).to(dev)
        radius = torch.tensor(1e-3, device=dev)        # strand_scale x scene scale 1
        roots = sample_roots(pool, n_strands, torch.Generator(device=dev).manual_seed(SEED))

        def run(name, main, argv, path):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loader.reset_launch_counts()
            t0 = time.perf_counter()
            state = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(loader.launches)
            for k in ("raster_fwd", "raster_bwd"):
                require(launches[k] == iters,
                        f"{name}: {k} launched {launches[k]} times in {iters} steps")
            recs = _metrics(path)
            require(recs and all(np.isfinite(r["total"]) for r in recs),
                    f"{name}: non-finite or missing losses {recs}")
            rates = _window_rates(recs)
            return state, {"iterations": iters, "wall_s": wall,
                           "it_per_s_median": statistics.median(rates), "it_per_s_windows": rates,
                           "losses": {str(r["step"]): {k: r[k] for k in ("total", "l1", "mask",
                                                                         "orient", "sds")}
                                      for r in recs},
                           "num_rendered_logged": {str(r["step"]): r["num_rendered"] for r in recs},
                           "launches": launches,
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

        s2, out["stage2"] = run("stage 2", train_latent_strands.main,
                                flags + ["--model_path_hair", hair, "--use_diffusion"], hair)
        require(all(out["stage2"]["launches"][k] == iters for k in TAIL_ENTRIES),
                f"stage 2: the fused optimizer tail launched {out['stage2']['launches']} "
                f"in {iters} steps")
        with torch.no_grad():
            hair2, _ = stage2.hair_fields_from_strands(s2.params, pool, scfg, roots, radius)
            layout = stage2.concat_fields(head, hair2)
            binned, _ = binned_fields(layout, 3, cam0, cfg)
        out["stage2"]["layout_camera0"] = layout_stats(binned, n_head)
        require(out["stage2"]["layout_camera0"]["hair_instances"] > 0,
                "stage 2: the strands produce no instance at camera 0")
        del binned
        ck2 = os.path.join(hair, "checkpoints", f"{iters}.npz")
        back2 = stage2.load_checkpoint(ck2, stage2.init_hair_state(scfg, device=dev))
        require(back2.step == iters and torch.equal(back2.params.texture, s2.params.texture)
                and all(torch.equal(a, b) for a, b in zip(back2.ema.parameters(),
                                                           s2.ema.parameters())),
                "stage 2: the checkpoint does not load back to the final state")
        out["stage2"]["checkpoint_mb"] = os.path.getsize(ck2) / 1e6
        del back2, s2

        s3, out["stage3"] = run("stage 3", train_strands.main,
                                flags + ["--model_path_hair", hair, "--model_path_curves", curves,
                                         "--start_checkpoint_hair", ck2, "--use_sds"], curves)
        with torch.no_grad():
            binned, _ = binned_fields(stage2.concat_fields(
                head, stage3.curves_fields(s3.params, s3.static, scfg, radius)), 3, cam0, cfg)
        out["stage3"]["layout_camera0"] = layout_stats(binned, n_head)
        require(out["stage3"]["layout_camera0"]["hair_instances"] > 0,
                "stage 3: the strands produce no instance at camera 0")
        del binned
        back3 = stage3.load_checkpoint(os.path.join(curves, "checkpoints", f"{iters}.npz"), dev)
        require(back3.step == iters and torch.equal(back3.params.dirs, s3.params.dirs),
                "stage 3: the checkpoint does not load back to the final state")

        loader.reset_launch_counts()
        pts = export_curves.main(["--data_dir", root, "--model_name", "smoke",
                                  "--iter", str(iters)])
        require(pts.shape == (n_strands, length, 3) and bool(np.isfinite(pts).all()),
                f"export: strands of shape {pts.shape}, finite {bool(np.isfinite(pts).all())}")
        require(np.array_equal(pts, stage3.export_points(s3)), "export: not the final strands")
        out["export"] = {"shape": list(pts.shape), "launches": dict(loader.launches),
                         "files": sorted(os.listdir(os.path.join(curves, "strands")))}
        if keep_ckpt:
            shutil.move(ck2, keep_ckpt)
    return out, (layout, n_head, cam0)


def kernel_strands_phase(torch, layout, cfg):
    """Both compositing kernels and the cull at the strand layout (camera
    0 of the final stage-2 state: the head and 990k strand Gaussians):
    bit-identical forward, row-by-row backward (two runs bit-identical),
    the card's warp masks against their plain mirror; times and bounds as
    the bench kernel phases count them.  The plain walks are timed once."""
    from gaussianhaircut_torch.ops.rasterize import common as C
    from gaussianhaircut_torch.ops.rasterize import cuda_core, plain_core
    from gaussianhaircut_torch.tools.profile_fixed import binned_fields, cuda_ms

    fields, n_head, cam0 = layout
    binned, binning = binned_fields(fields, 3, cam0, cfg)
    lay = (binned.payload, binned.chunk_start, binned.nchunks)
    used_chunks = int(binned.nchunks.sum())
    culled, masks = cull_stats(binned, WIDTH, HEIGHT, cfg)
    stats = {}
    t0 = time.perf_counter()
    plain_buf = plain_core.raster_fwd_plain(*lay, WIDTH, HEIGHT, cfg, stats=stats, masks=masks)
    torch.cuda.synchronize()
    plain_fwd_s = time.perf_counter() - t0
    got = cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "strand forward: non-finite output")
    require(torch.equal(got, plain_buf), "strand forward: not bit-identical to its plain "
            f"version (max err {float((got - plain_buf).abs().max())})")
    gbuf = seeded_cotangent(torch, cfg, fields.xyz.device)
    bargs = (*lay, got, gbuf, WIDTH, HEIGHT, cfg)
    d1 = cuda_core.raster_bwd(*bargs)
    d2 = cuda_core.raster_bwd(*bargs)
    t0 = time.perf_counter()
    plain = plain_core.raster_bwd_plain(*bargs)
    torch.cuda.synchronize()
    plain_bwd_s = time.perf_counter() - t0
    require(bool(torch.isfinite(d1).all()), "strand backward: non-finite output")
    require(torch.equal(d1, d2), "strand backward: two runs differ")
    rows = hold_dpay(d1, plain)
    in_bytes = used_chunks * 16 * cfg.chunk * 4 + 2 * binned.num_tiles * 4
    buf_bytes = binned.num_tiles * cfg.tile_pix * C.PAD_CHANNELS * 4
    fwd_ms = cuda_ms(lambda: cuda_core.raster_fwd(*lay, WIDTH, HEIGHT, cfg), REPS)
    bwd_ms = cuda_ms(lambda: cuda_core.raster_bwd(*bargs), REPS)
    fb_ms, fb_by = bound_ms(in_bytes + buf_bytes,
                            stats["kept"] * OPS_VISIT + stats["contrib"] * OPS_BLEND_FWD)
    # the probe on the same layout, held as the probe phase holds it
    probe = cuda_core.raster_probe(*lay, WIDTH, HEIGHT, cfg)
    t0 = time.perf_counter()
    probe_plain = plain_core.raster_probe_plain(*lay, cfg)
    torch.cuda.synchronize()
    probe_plain_s = time.perf_counter() - t0
    abs_sum = plain_core.raster_probe_plain(binned.payload.abs(), *lay[1:], cfg)[:, 0, 0]
    probe_err = (probe - probe_plain).abs().amax(dim=(1, 2))
    require(bool((probe_err <= 1e-5 * (abs_sum + 1.0)).all()),
            f"strand probe: error beyond 1e-5 x (sum|row 0| + 1): {float(probe_err.max())}")
    probe_ms = cuda_ms(lambda: cuda_core.raster_probe(*lay, WIDTH, HEIGHT, cfg), REPS)
    pb_ms, pb_by = bound_ms(in_bytes + buf_bytes,
                            used_chunks * (cfg.chunk + cfg.tile_pix * (cfg.chunk // 32 + 16)))
    bb_ms, bb_by = bound_ms(in_bytes + 2 * buf_bytes + used_chunks * C.GRAD_ROWS * cfg.chunk * 4,
                            stats["kept"] * OPS_VISIT + stats["contrib"] * OPS_BLEND_BWD)
    return {"phase": "kernel_strands", **layout_stats(binned, n_head),
            "tiles": binned.num_tiles, "binning_ms": cuda_ms(binning, 5),
            "pairs_visited": stats["visited"], "pairs_visited_kept": stats["kept"],
            "pairs_blended": stats["contrib"], "cull": culled,
            "fwd_bit_identical": True, "bwd_runs_bit_identical": True, "bwd_rows": rows,
            "bwd_max_abs_err": float((d1 - plain).abs().max()),
            "raster_fwd": {"ms": fwd_ms, "plain_s_once": plain_fwd_s, "bound_ms": fb_ms,
                           "bound_by": fb_by, "bound_share": fb_ms / fwd_ms},
            "raster_bwd": {"ms": bwd_ms, "plain_s_once": plain_bwd_s, "bound_ms": bb_ms,
                           "bound_by": bb_by, "bound_share": bb_ms / bwd_ms},
            "raster_probe": {"ms": probe_ms, "plain_s_once": probe_plain_s,
                             "max_abs_err": float(probe_err.max()), "bound_ms": pb_ms,
                             "bound_by": pb_by, "bound_share": pb_ms / probe_ms},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


class StageClock:
    """Standard output for ``cli.run_pipeline``: passes everything on and,
    at each line where it reports a stage done (``run_pipeline.stages_done``),
    records the seconds since the previous one (after a device sync) and the
    kernel launches in between; keeps the selection-tier line of the sphere
    crop."""

    def __init__(self, torch, stream, launches, stages_done):
        self.torch, self.stream, self.launches = torch, stream, launches
        self.stages_done = stages_done
        self.last, self.prev = time.perf_counter(), dict(launches)
        self.seconds, self.stage_launches, self.notes = {}, {}, []

    def write(self, text):
        for stage in self.stages_done(text):
            self.torch.cuda.synchronize()
            now = time.perf_counter()
            self.seconds[stage] = now - self.last
            self.stage_launches[stage] = {k: v - self.prev[k] for k, v in self.launches.items()}
            self.last, self.prev = now, dict(self.launches)
        if "[scale_scene_into_sphere]" in text:
            self.notes.append(text.strip())
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def pipeline_scene(torch, fields, n_head, root, cfg):
    """The pipeline's input scene under ``root``: PIPE_VIEWS views on the
    bench ring at PIPE_WIDTH x PIPE_HEIGHT rendered from ``fields`` (the
    image, the hair mask from the label channel, the body mask) with the
    head rows (the first ``n_head``) above y = 0 left out, so that the
    strands on the scalp cap show from every view; COLMAP text
    with the bench blob's 100k points, and a 9,936-face sphere head under
    the scalp cap with its cap as the scalp.  Returns the build seconds and
    each view's hair share (mask > 127)."""
    from gaussianhaircut_torch.render.renderer import default_background, render_fields
    from gaussianhaircut_torch.scene.cameras import CameraBatch, camera_geom
    from gaussianhaircut_torch.scene.synthetic import (
        bench_scene, ring_cameras, sphere_mesh, write_pipeline_scene)

    import dataclasses
    t0 = time.perf_counter()
    dev = fields.xyz.device
    valid = fields.valid.clone()
    valid[:n_head] &= fields.xyz[:n_head, 1] < 0
    fields = dataclasses.replace(fields, valid=valid)
    cams = ring_cameras(PIPE_VIEWS, PIPE_WIDTH, PIPE_HEIGHT)
    batch = CameraBatch.from_cameras(cams, dev)
    bg = default_background(False, dev)
    u8 = lambda t: (t.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()
    images, hair, body = [], [], []
    with torch.no_grad():
        for i in range(PIPE_VIEWS):
            geom = camera_geom(batch.colmap_transform[i], batch.fovx[i], batch.fovy[i],
                               PIPE_WIDTH, PIPE_HEIGHT)
            out = render_fields(fields, 3, geom, bg, cfg)
            images.append(u8(out["render"].permute(1, 2, 0)))
            hair.append(u8(out["mask"][0]))
            body.append(u8(out["mask"][1]))
    blob = bench_scene(P, 8, 8, 1, SEED)            # the bench blob's points
    write_pipeline_scene(root, cams, np.stack(images), np.stack(hair), np.stack(body),
                         blob.points, blob.colors, head=sphere_mesh())
    share = [float((h > 127).mean()) for h in hair]
    require(min(share) > 0, f"pipeline: a view renders no hair {share}")
    return time.perf_counter() - t0, share


def pipeline_phase(torch, layout, cfg, then=None):
    """``cli.run_pipeline`` on a scene rendered from the strand layout,
    then ``cli.export_strands`` and ``cli.metrics``; the checks and numbers
    of the module docstring's item 10.  ``then(scene_dir, root)`` runs last,
    before the scene is removed."""
    import contextlib
    import pickle
    import shutil
    import tempfile
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.cli import export_strands, metrics, render_strands, run_pipeline
    from gaussianhaircut_torch.cli.metrics import load_rgb
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.models.textured_strands import TexturedStrandsConfig
    from gaussianhaircut_torch.ops.lpips import lpips_or_none
    from gaussianhaircut_torch.preprocessing import orientation_maps as om
    from gaussianhaircut_torch.preprocessing.scene_tools import winding_numbers
    from gaussianhaircut_torch.tools.profile_fixed import cuda_ms
    from gaussianhaircut_torch.train import stage2, stage3
    from gaussianhaircut_torch.utils import mesh as mesh_util
    from gaussianhaircut_torch.utils.image import read_png

    fields, n_head = layout[:2]
    dev = fields.xyz.device
    i1, i2, i3 = PIPE_ITERS
    names = [f"{i:06d}.png" for i in range(PIPE_VIEWS)]
    out = {"phase": "pipeline", "views": PIPE_VIEWS, "raw_size": [PIPE_WIDTH, PIPE_HEIGHT],
           "iterations": list(PIPE_ITERS)}
    with tempfile.TemporaryDirectory(prefix="ghpipe_") as root:
        data = os.path.join(root, "scene")
        out["scene_build_s"], out["hair_share_by_view"] = pipeline_scene(
            torch, fields, n_head, data, cfg)
        del fields

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loader.reset_launch_counts()
        clock = StageClock(torch, sys.stdout, loader.launches, run_pipeline.stages_done)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(clock):
            run_pipeline.main(["--data_path", data, "--iters1", str(i1), "--iters2", str(i2),
                               "--iters3", str(i3)])
        torch.cuda.synchronize()
        out["pipeline_s"] = time.perf_counter() - t0
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["stage_seconds"] = clock.seconds
        out["launches_by_stage"] = clock.stage_launches
        out["launches"] = dict(loader.launches)
        out["sphere_crop"] = clock.notes
        # one forward per rendered view, one forward and backward per step
        expect = {"stage1": (i1, i1), "render_gaussians": (PIPE_VIEWS, 0),
                  "stage2": (i2, i2), "stage3": (i3, i3), "export": (PIPE_VIEWS, 0)}
        stages = ("frames", "colmap", "masks", "resize", "orientations", "parsing", "stage1",
                  "flame", "crop", "render_gaussians", "stage2", "stage3", "export")
        require(list(clock.seconds) == list(stages),
                f"pipeline: stages {list(clock.seconds)}, expected {list(stages)}")
        for st in stages:
            got = clock.stage_launches[st]
            want = dict(zip(("raster_fwd", "raster_bwd"), expect.get(st, (0, 0))))
            require(all(got[k] == v for k, v in want.items()),
                    f"pipeline: {st} launched {got}, expected {want}")

        # every stage's files exist and load back
        model = os.path.join(data, "3d_gaussian_splatting", "stage1")
        for sub in ("images_2", "images_4", "masks_2/hair", "masks_4/body",
                    "orientations_2/angles", "orientations_2/vars", "orientations_2/filtered",
                    "orientations_2/vis"):
            require(len(os.listdir(os.path.join(data, sub))) == PIPE_VIEWS, f"pipeline: {sub}")
        require(read_png(os.path.join(data, "images_2", names[0])).shape == (HEIGHT, WIDTH, 3),
                "pipeline: images_2 is not the bench size")
        for name in names:
            v = np.load(os.path.join(data, "orientations_2", "vars", name[:-4] + ".npy"))
            require(v.dtype == np.float16 and np.isfinite(v).all(), "pipeline: variance npy")
        with np.load(os.path.join(data, "cameras.npz")) as z:
            require(len(z.files) == 2 * PIPE_VIEWS, f"pipeline: cameras.npz {z.files}")
        with open(os.path.join(data, "scale.pickle"), "rb") as f:
            out["scale"] = pickle.load(f)
        rows = {}
        for sub in ("point_cloud", "point_cloud_cropped", "point_cloud_filtered"):
            st = gm.load_ply(os.path.join(model, sub, f"iteration_{i1}", "raw_point_cloud.ply"),
                             0, 3, device="cpu")
            rows[sub] = st.num_alive()
        require(rows["point_cloud"] >= rows["point_cloud_cropped"]
                >= rows["point_cloud_filtered"] > 0, f"pipeline: PLY rows {rows}")
        out["ply_rows"] = rows
        scfg = TexturedStrandsConfig(num_strands=N_STRANDS, texture_size=TEXTURE,
                                     strand_length=STRAND_LEN, diffusion_input=DIFF_INPUT,
                                     use_diffusion=True)
        ck2 = stage2.load_checkpoint(
            os.path.join(data, "strands_reconstruction", "stage2", "checkpoints", f"{i2}.npz"),
            stage2.init_hair_state(scfg, device=dev))
        ck3 = stage3.load_checkpoint(
            os.path.join(data, "curves_reconstruction", "stage3", "checkpoints", f"{i3}.npz"), dev)
        require(ck2.step == i2 and ck3.step == i3, "pipeline: checkpoints do not load back")
        del ck2
        with open(os.path.join(data, "curves_reconstruction", "stage3", "strands",
                               f"{i3}_strands.pkl"), "rb") as f:
            curves = pickle.load(f)
        require(curves.shape == (N_STRANDS, STRAND_LEN, 3) and np.isfinite(curves).all(),
                f"pipeline: exported curves {curves.shape}")
        require(np.array_equal(curves, stage3.export_points(ck3)), "pipeline: export differs")
        del ck3
        hair_dir = os.path.join(data, "strands_reconstruction", "stage2", "train", f"ours_{i1}")
        kinds = sorted(os.listdir(hair_dir))
        require(len(kinds) == 7 and all(len(os.listdir(os.path.join(hair_dir, k))) == PIPE_VIEWS
                                        for k in kinds), f"pipeline: render_strands {kinds}")

        # the orientation map of one view on the card and on the CPU
        img = read_png(os.path.join(data, "images_2", names[0]))
        deg_c, var_c, filt_c = om.calc_orientation_map(img, device=dev)
        deg_h, var_h, filt_h = om.calc_orientation_map(img, device="cpu")
        bank, _ = om.build_gabor_bank(180)
        with torch.no_grad():
            top2 = torch.topk(om.gabor_responses(torch.from_numpy(filt_h),
                                                 torch.from_numpy(bank)), 2, dim=0).values
        clear = ((top2[0] - top2[1]) > ORIENT_RESP_REL * top2[0]).numpy()
        orient = {"max_err_filtered": float(np.abs(filt_c - filt_h).max()),
                  "clear_share": float(clear.mean()),
                  "deg_mismatch_clear": int((deg_c != deg_h)[clear].sum()),
                  "deg_mismatch_near_ties": int((deg_c != deg_h)[~clear].sum()),
                  "max_err_var_clear": float(np.abs(var_c - var_h)[clear].max())}
        require(orient["max_err_filtered"] <= ORIENT_FILTERED_ATOL
                and orient["deg_mismatch_clear"] == 0
                and orient["max_err_var_clear"] <= ORIENT_VAR_ATOL,
                f"pipeline: orientation map on the card differs from the CPU's {orient}")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            om.calc_orientation_map(img, device=dev)
            times.append((time.perf_counter() - t0) * 1e3)
        orient["ms_per_view"] = statistics.median(times)
        gray = torch.as_tensor(np.asarray(img, np.float32) / 255.0 @ np.array(
            [0.2989, 0.5870, 0.1140], np.float32), device=dev)
        bank_d, thetas_d = (torch.as_tensor(a, device=dev) for a in om.build_gabor_bank(180))
        with torch.no_grad():
            orient["device_ms_per_view"] = cuda_ms(lambda: om.orients_from_filtered(
                om.difference_of_gaussians(gray, 0.4, 10.0), bank_d, thetas_d, 180), 5)
        out["orientation"] = orient

        # render_strands again, timed on its own
        loader.reset_launch_counts()
        t0 = time.perf_counter()
        render_strands.main(["-s", data, "-m", model, "--model_hair_path",
                             os.path.join(root, "rerender"), "--checkpoint_curves",
                             os.path.join(data, "curves_reconstruction", "stage3",
                                          "checkpoints", f"{i3}.npz"), "--skip_test"])
        torch.cuda.synchronize()
        out["render_strands_s_per_view"] = (time.perf_counter() - t0) / PIPE_VIEWS
        require(loader.launches["raster_fwd"] == PIPE_VIEWS
                and loader.launches["raster_bwd"] == 0,
                f"pipeline: render_strands launched {dict(loader.launches)}")

        # export_strands at 30,000 strands, pruned by the head on the card
        flame = os.path.join(data, "flame_fitting", "stage1")
        t0 = time.perf_counter()
        exp = export_strands.main(["--data_dir", data, "--model_name", "stage2",
                                   "--flame_mesh_dir", flame, "--iter", str(i2),
                                   "--num_strands", str(EXPORT_STRANDS),
                                   "--texture_size", str(TEXTURE)])
        torch.cuda.synchronize()
        pts = exp["points"]
        require(pts.shape[1:] == (STRAND_LEN, 3) and pts.shape[0] > 0
                and np.isfinite(pts).all(), f"pipeline: export_strands {pts.shape}")
        out["export_strands"] = {"s": time.perf_counter() - t0, "kept": int(exp["keep"].sum()),
                                 "strands": EXPORT_STRANDS, "sdf_terms": exp["sdf_terms"],
                                 "sdf_s": exp["sdf_s"],
                                 "winding_terms_per_s": exp["sdf_terms"] / exp["sdf_s"]}

        # the winding number of sampled points on the card and on the CPU
        head = mesh_util.load_obj(os.path.join(flame, "stage_3", "mesh_final.obj"))
        rng = np.random.default_rng(SEED)
        flat = pts.reshape(-1, 3)
        sample = np.concatenate([flat[rng.choice(len(flat), 2048, replace=False)],
                                 rng.uniform(-0.15, 0.15, (2048, 3)) + [0.0, 0.05, 0.0]])
        wn_c = winding_numbers(sample, head, dev).cpu().numpy()
        wn_h = winding_numbers(sample, head, "cpu").numpy()
        far = np.abs(wn_h - 0.5) > WINDING_MARGIN
        out["winding_check"] = {"points": len(sample), "inside": int((wn_h > 0.5).sum()),
                                "near_surface": int((~far).sum()),
                                "max_abs_err": float(np.abs(wn_c - wn_h).max())}
        require(out["winding_check"]["max_abs_err"] <= WINDING_ATOL
                and np.array_equal((wn_c > 0.5)[far], (wn_h > 0.5)[far]),
                f"pipeline: winding numbers on the card differ {out['winding_check']}")

        # metrics: the strand renders against images_2
        method = os.path.join(root, "eval", "test", "ours")
        shutil.copytree(os.path.join(hair_dir, "renders"), os.path.join(method, "renders"))
        shutil.copytree(os.path.join(data, "images_2"), os.path.join(method, "gt"))
        t0 = time.perf_counter()
        res = metrics.main(["-m", os.path.join(root, "eval")])[os.path.join(root, "eval")]
        out["metrics"] = dict(res["ours"], s=time.perf_counter() - t0)
        require(all(np.isfinite(v) for k, v in res["ours"].items() if k != "LPIPS_kind")
                and "LPIPS[untrained-seeded]" in res["ours"], f"pipeline: metrics {res}")
        lp = lpips_or_none(None, allow_untrained=True, device=dev)
        r = load_rgb(os.path.join(method, "renders", names[0]), dev)[None]
        g = load_rgb(os.path.join(method, "gt", names[0]), dev)[None]
        out["lpips_ms_per_pair"] = cuda_ms(lambda: lp.distance(r, g), 5)
        out["lpips_kind"] = lp.kind
        out["scalp"] = scalp_step(torch, data, os.path.join(root, "scalp_fit"), flame, i1, dev)
        if then is not None:
            then(data, root)
    return out


def scalp_step(torch, data, fit, flame, iteration, dev):
    """The scalp stage on the pipeline's scene: its sphere head (copied to
    ``fit``, so that the scene's own scalp files stay), the masks the resize
    stage wrote and the stage-1 camera matrices.  One view's pixel-to-face
    map is held against the plain numpy loop."""
    import pickle
    import shutil
    from gaussianhaircut_torch.preprocessing import scalp
    from gaussianhaircut_torch.utils import mesh as mesh_util
    from gaussianhaircut_torch.utils.image import read_png

    shutil.copytree(flame, fit)
    with open(os.path.join(data, "3d_gaussian_splatting", "stage1", "cameras",
                           f"{iteration}_matrices.pkl"), "rb") as f:
        matrices = pickle.load(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scalp.extract_scalp(fit, data, matrices, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    head = mesh_util.load_obj(os.path.join(fit, "stage_3", "mesh_final.obj"))
    name, full = next(iter(matrices.items()))
    h, w = read_png(os.path.join(data, "masks_2", "hair", f"{name}.png")).shape[:2]
    pix, depth = scalp.view_pixels(head.verts, full, w, h)
    card = scalp.rasterize_pix_to_face(pix, depth, head.faces, w, h, dev)
    plain = scalp.rasterize_pix_to_face_plain(pix, depth, head.faces, w, h)
    require(np.array_equal(card, plain), f"scalp: the card's pixel-to-face map differs "
            f"from the plain loop at {int((card != plain).sum())} pixels")
    out_dir = os.path.join(fit, "scalp_data")
    with open(os.path.join(out_dir, "cut_scalp_verts.pickle"), "rb") as f:
        used = np.asarray(pickle.load(f), np.int64)
    cut = mesh_util.load_obj(os.path.join(out_dir, "scalp.obj"))
    mask = read_png(os.path.join(out_dir, "dif_mask.png"))
    require(len(used) > 0 and used.max() < len(head.verts) and len(np.unique(used)) == len(used)
            and np.array_equal(cut.verts, head.verts[used]) and len(cut.faces) > 0
            and cut.uvs is not None, f"scalp: a cut of {len(used)} vertices, "
            f"{len(cut.faces)} faces is not a non-empty part of the head")
    require(mask.shape == (256, 256) and (mask > 0).any(), "scalp: empty dif_mask")
    return {"s": seconds, "views": len(matrices), "head_faces": len(head.faces),
            "scalp_verts": len(used), "scalp_faces": len(cut.faces),
            "dif_mask_share": float((mask > 0).mean()), "p2f_view": name,
            "p2f_covered": int((card >= 0).sum()), "p2f_equal_plain": True}


def quality_phase(torch, dev):
    """The strand gate, the stage-1 harness at QUALITY_r05.json's widths and
    the full-width distillation: the checks of the module docstring's item
    11."""
    from gaussianhaircut_torch import kernels as loader

    def launched(fn):
        torch.cuda.synchronize()
        loader.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, dict(loader.launches), time.perf_counter() - t0

    out = {"phase": "quality"}
    gate, launches, secs = launched(lambda: strand_gate(torch, dev))
    expect = gate.pop("expected_launches")
    require(launches["raster_fwd"] == expect[0] and launches["raster_bwd"] == expect[1],
            f"strand gate: launched {launches}, expected {expect}")
    out["strand_gate"] = dict(gate, launches=launches, s=secs)

    from gaussianhaircut_torch.tools import quality_run
    args = quality_run.parse_args([
        "--iters", str(QR_ITERS), "--teacher_p", str(QR_TEACHER), "--res", str(QR_RES),
        "--views", str(QR_VIEWS), "--test_views", str(QR_TEST_VIEWS),
        "--eval_every", str(QR_ITERS), "--device", dev.type])
    rec, launches, secs = launched(lambda: quality_run.run(args))
    # renders: the ground truth, the held-out curve (the test views and five
    # train views), the final evaluation and the LPIPS views
    renders = (QR_VIEWS + QR_TEST_VIEWS) + (QR_TEST_VIEWS + 5) + (QR_VIEWS + QR_TEST_VIEWS) \
        + QR_TEST_VIEWS
    require(launches["raster_fwd"] == QR_ITERS + renders and launches["raster_bwd"] == QR_ITERS,
            f"quality_run: launched {launches}, expected {QR_ITERS} steps + {renders} renders")
    require(all(np.isfinite(rec[k]) for k in ("train_psnr", "test_psnr")),
            f"quality_run: {rec}")
    out["quality_run"] = dict(rec, launches=launches, s=secs,
                              jax_test_psnr_at_3000=QR_JAX_TEST_PSNR_3000)
    out["distill_full_width"] = distill_full_width(torch, dev)
    return out


def strand_gate(torch, dev):
    """tests/test_quality_gate_strands.py on the card, through the port's
    harness pieces (``tools.quality_strands``) and trainers."""
    from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussianhaircut_torch.models.textured_strands import (
        TexturedStrandsConfig, sample_roots, synthetic_scalp_pool)
    from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
    from gaussianhaircut_torch.tools import quality_strands as qs
    from gaussianhaircut_torch.train import stage2, stage3
    from gaussianhaircut_torch.train.prior import distill_strand_prior

    res, n_views, n_test, iters2, iters3, prior_steps = 96, 10, 3, 500, 300, 120
    rng = np.random.default_rng(0)
    pool = synthetic_scalp_pool(4000)
    radius_scale = torch.tensor(2e-3, device=dev)
    scfg = TexturedStrandsConfig(num_strands=384, texture_size=64, strand_length=16,
                                 sh_degree=1, pool_size=4000, use_diffusion=False)
    t_pts, t_rgb, _, _ = qs.teacher_strands(pool, 512, 16, rng, dev)
    head_model = qs.make_head_model(rng, capacity=1024, n=512, device=dev)
    head = stage2.make_head_fields(head_model)
    raster_cfg = RasterConfig(tile_w=16, tile_h=16, chunk=64)
    cams = qs.make_cameras(n_views + n_test, res, res)
    qs.attach_gt(cams, stage2.concat_fields(head, qs.teacher_fields(
        t_pts, t_rgb, radius_scale, scfg.sh_degree)), scfg.sh_degree, raster_cfg)

    class Scene:
        train_cameras = cams[:n_views]
        test_cameras = cams[n_views:]

    model_cfg = ModelConfig()
    pipe_cfg = PipelineConfig(tile=16)
    scene_scale = float(radius_scale) / model_cfg.strand_scale
    t0 = time.perf_counter()
    hair_state = stage2.train(
        model_cfg, OptimizationConfig(iterations=iters2, lambda_dmask=0.1, lambda_dorient=0.1,
                                      train_orient_conf=False),
        scfg, pipe_cfg, Scene, head_model, pool, scene_scale, device=dev)
    torch.cuda.synchronize()
    s2_s = time.perf_counter() - t0
    pool_d = pool.to(dev)
    with torch.no_grad():
        hair2, _ = stage2.hair_fields_from_strands(
            hair_state.params, pool_d, scfg,
            sample_roots(pool_d, scfg.num_strands, torch.Generator(device=dev).manual_seed(42)),
            radius_scale)
    psnr2 = qs.evaluate(hair2, head, Scene.test_cameras, "s", 1, raster_cfg)["s_psnr"]

    t_flat = t_pts.reshape(-1, 3)
    roots = sample_roots(pool, 384, torch.Generator().manual_seed(1))
    params0, static0 = stage3.create_from_stage2(hair_state.params, pool_d, scfg, roots.to(dev))
    pts0 = stage3.curves_points(params0, static0)
    chamfer0 = qs.strand_chamfer(pts0, t_flat)
    prior3, pinfo = distill_strand_prior(pts0, static0.uvs, static0.local2world, scfg,
                                         steps=prior_steps, seed=2000, device=dev)
    t0 = time.perf_counter()
    curves = stage3.train(
        model_cfg, OptimizationConfig(iterations=iters3, lambda_dmask=0.1, lambda_dorient=0.1,
                                      lambda_dssim=0.2, lambda_dsds=0.01,
                                      train_orient_conf=False),
        scfg, pipe_cfg, Scene, head_model, hair_state.params, pool, scene_scale,
        num_strands=384, checkpoint_iterations=(), prior=prior3, use_sds=True, device=dev)
    torch.cuda.synchronize()
    s3_s = time.perf_counter() - t0
    with torch.no_grad():
        hair3 = stage3.curves_fields(curves.params, curves.static, scfg, radius_scale)
    psnr3 = qs.evaluate(hair3, head, Scene.test_cameras, "s", 1, raster_cfg)["s_psnr"]
    chamfer3 = qs.strand_chamfer(stage3.curves_points(curves.params, curves.static), t_flat)
    out = {"stage2_test_psnr": psnr2, "stage3_test_psnr": psnr3, "chamfer_init": chamfer0,
           "chamfer_stage3": chamfer3, "chamfer_drift": chamfer3 / chamfer0, **pinfo,
           "floors": [STAGE2_PSNR_FLOOR, STAGE3_PSNR_FLOOR, CHAMFER_DRIFT_MAX],
           "stage2_it_per_s": iters2 / s2_s, "stage3_it_per_s": iters3 / s3_s,
           "expected_launches": (n_views + n_test + iters2 + n_test + iters3 + n_test,
                                 iters2 + iters3)}
    require(psnr2 >= STAGE2_PSNR_FLOOR and psnr3 >= STAGE3_PSNR_FLOOR
            and chamfer3 <= CHAMFER_DRIFT_MAX * chamfer0, f"strand gate failed: {out}")
    return out


def distill_full_width(torch, dev):
    """``distill_strand_prior`` at the full-width defaults (the UNet at
    128/256/512 on the 32x32 grid) for DISTILL_STEPS steps on the strand
    harness's teacher at 10,000 x 100; the loss must fall on a fixed
    yardstick (``prior_loss`` over 8 seeded draws, before and after: the
    per-step losses swing with each step's sigma); the prior goes through
    ``prior_io`` and back."""
    import tempfile
    from gaussianhaircut_torch.models import prior_io
    from gaussianhaircut_torch.models.diffusion import Denoiser
    from gaussianhaircut_torch.models.textured_strands import (
        TexturedStrandsConfig, synthetic_scalp_pool)
    from gaussianhaircut_torch.tools.quality_strands import teacher_strands
    from gaussianhaircut_torch.train import prior as P

    scfg = TexturedStrandsConfig(num_strands=N_STRANDS, strand_length=STRAND_LEN,
                                 texture_size=TEXTURE, diffusion_input=DIFF_INPUT)
    pts, _, uvs, l2w = teacher_strands(synthetic_scalp_pool(scfg.pool_size), N_STRANDS,
                                       STRAND_LEN, np.random.default_rng(SEED), dev)
    cfg = P.DiffusionConfig(input_channels=P.GEOMETRY_DIM, input_size=DIFF_INPUT)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    yardstick = [P.draw_prior(N_STRANDS, 1000, cfg, gen) for _ in range(8)]
    fresh = {"encoder": P.fixed_encoder(STRAND_LEN).to(dev),
             "denoiser": Denoiser(cfg).init_weights(torch.Generator().manual_seed(SEED)).to(dev)}
    before = P.prior_loss(fresh, pts, uvs, l2w, scfg, yardstick, dev)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prior, info = P.distill_strand_prior(pts, uvs, l2w, scfg, steps=DISTILL_STEPS, seed=SEED,
                                         denoiser=fresh["denoiser"], device=dev,
                                         progress_callback=lambda i, lv: losses.append(lv))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / DISTILL_STEPS
    after = P.prior_loss(prior, pts, uvs, l2w, scfg, yardstick, dev)
    require(np.isfinite(losses).all() and after < before,
            f"distillation: the loss did not fall on the yardstick ({before} -> {after})")
    with tempfile.TemporaryDirectory(prefix="ghprior_") as d:
        path = os.path.join(d, "prior.npz")
        prior_io.save_prior(path, prior)
        back = prior_io.load_prior(path, STRAND_LEN, DIFF_INPUT, dev)
        require(set(back) == {"encoder", "denoiser"} and all(
            torch.equal(a, b) for k in back for a, b in zip(back[k].parameters(),
                                                            prior[k].parameters())),
                "distillation: the prior does not load back through prior_io")
        mb = os.path.getsize(path) / 1e6
    return {"strands": N_STRANDS, "strand_length": STRAND_LEN, "diffusion_input": DIFF_INPUT,
            "steps": DISTILL_STEPS, "ms_per_step": ms, "yardstick_loss_before": before,
            "yardstick_loss_after": after, "loss_first20_mean": float(np.mean(losses[:20])),
            "loss_last20_mean": float(np.mean(losses[-20:])), **info, "prior_mb": mb}


TOOL_PARTS = ("selftests", "convert_lpips", "build_scene", "convert_hyperiqa",
              "convert_neuralhaircut_ckpt", "s3_lr_probe")


def tools_phase(torch, root, ck2, scene, fields, cfg, dev):
    """The converter and record tools under ``root`` (module doc, phase
    tools), each given ``--device`` ``dev``: ``ck2`` is the strands phase's
    stage-2 checkpoint, ``fields`` its final layout.  Each part's seconds,
    launches and peak memory."""
    from gaussianhaircut_torch import kernels as loader
    from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussianhaircut_torch.models import prior_io
    from gaussianhaircut_torch.ops.lpips import LPIPS, synthesize_weights
    from gaussianhaircut_torch.preprocessing import iqa
    from gaussianhaircut_torch.render.renderer import default_background, render_fields
    from gaussianhaircut_torch.tools import (
        convert_hyperiqa, convert_lpips, convert_neuralhaircut_ckpt, pipeline_e2e_run,
        s3_lr_probe)
    from gaussianhaircut_torch.tools.profile_fixed import scene_camera
    from gaussianhaircut_torch.train import stage2
    from gaussianhaircut_torch.utils.image import read_png
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import upstream_twins

    on_dev = ["--device", dev.type]
    out = {"phase": "tools"}

    def part(name, fn):
        path = list(sys.path)           # an upstream tree goes on the path
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loader.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = fn()
        finally:
            sys.path[:] = path
        torch.cuda.synchronize()
        out[name] = dict(res, s=time.perf_counter() - t0, launches=dict(loader.launches),
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        return out[name]

    def expect_launches(name, fwd, bwd):
        got = out[name]["launches"]
        require(got["raster_fwd"] == fwd and got["raster_bwd"] == bwd,
                f"{name}: launched {got}, expected {fwd} forward and {bwd} backward")

    def selftests():
        rc = {m.__name__.rsplit(".", 1)[1]: m.selftest(dev)
              for m in (convert_lpips, convert_neuralhaircut_ckpt, convert_hyperiqa)}
        require(all(v == 0 for v in rc.values()), f"selftests: {rc}")
        return {"rc": rc}

    def lpips():
        blob = synthesize_weights(0)
        vgg, heads = upstream_twins.write_lpips_files(os.path.join(root, "lpips_src"), blob,
                                                      classifier=True)
        named = os.path.join(os.path.dirname(vgg), f"vgg16-{convert_lpips._sha256(vgg)[:8]}.pth")
        os.rename(vgg, named)
        npz = os.path.join(root, "lpips_vgg.npz")
        require(convert_lpips.main(["--vgg16", named, "--lpips_heads", heads, "--out", npz]
                                   + on_dev) == 0, "convert_lpips: the conversion failed")
        with np.load(npz) as z:
            got = dict(z)
        differ = [k for k, v in blob.items()
                  if k != "kind" and not (got[k].dtype == v.dtype and np.array_equal(got[k], v))]
        require(not differ and str(got["kind"]) == "pretrained",
                f"convert_lpips: keys {differ} differ from the blob the files hold")
        require(convert_lpips.main(["--verify", npz] + on_dev) == 0,
                "convert_lpips: --verify failed")
        bg = default_background(False, dev)
        with torch.no_grad():
            a, b = (torch.clamp(render_fields(fields, 3, scene_camera(scene, i, dev), bg,
                                              cfg)["render"], 0.0, 1.0) for i in (0, 1))
        card = float(LPIPS(npz, device=dev)(a, b))
        plain = float(LPIPS(npz, device="cpu")(a.cpu(), b.cpu()))
        require(plain > 0, "convert_lpips: the two renders are alike, so LPIPS cannot fail")
        rel = abs(card - plain) / max(abs(plain), 1e-30)
        require(np.isfinite(card) and rel <= LPIPS_CARD_RTOL,
                f"convert_lpips: LPIPS {card} on the card, {plain} on the CPU")
        return {"vgg16_mb": os.path.getsize(named) / 1e6, "render_shape": list(a.shape),
                "lpips_card": card, "lpips_cpu": plain, "rel_err": rel,
                "fixture_d_ab": float(got["fixture_d_ab"]),
                "fixture_d_ac": float(got["fixture_d_ac"])}

    scene_dir = os.path.join(root, "pipeline_scene")

    def build_scene():
        info = pipeline_e2e_run.build_scene(scene_dir, E2E_VIEWS, E2E_RES, N_STRANDS, STRAND_LEN,
                                            device=dev)
        names = sorted(os.listdir(os.path.join(scene_dir, "images")))
        require(len(names) == E2E_VIEWS and all(
            os.path.exists(os.path.join(scene_dir, "masks", m, n))
            for m in ("hair", "face", "body") for n in names),
            f"build_scene: {len(names)} views, or masks missing")
        require(sorted(os.listdir(os.path.join(scene_dir, "sparse", "0"))) == [
            "cameras.txt", "images.txt", "points3D.txt"], "build_scene: the COLMAP text model")
        img = read_png(os.path.join(scene_dir, "images", names[0]))
        hair = read_png(os.path.join(scene_dir, "masks", "hair", names[0]))
        require(img.shape == (E2E_RES, E2E_RES, 3) and hair.any(),
                f"build_scene: view of shape {img.shape}, hair mask empty: {not hair.any()}")
        return dict(info, views=len(names), scene_mb=sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(scene_dir) for f in fs) / 1e6)

    def hyperiqa():
        hq = upstream_twins.write_hyperiqa_tree(root)
        npz = os.path.join(root, "hyperiqa_distilled.npz")
        frames = os.path.join(scene_dir, "images")
        require(convert_hyperiqa.main(["--hyperiqa_dir", hq, "--frames_dir", frames, "--out", npz,
                                       "--steps", str(IQA_STEPS)] + on_dev) == 0,
                "convert_hyperiqa: the conversion failed")
        scorer = iqa.CnnScorer(npz, dev)
        scores = [scorer.score(read_png(os.path.join(frames, n)))
                  for n in sorted(os.listdir(frames))]
        x = torch.as_tensor(convert_hyperiqa.load_frames(frames))
        with torch.no_grad():
            card = scorer(x.to(dev)).cpu()
            plain = iqa.CnnScorer(npz, device="cpu")(x)
        err = float((card - plain).abs().max() / plain.abs().max())
        require(scorer.kind == "distilled-hyperiqa" and np.isfinite(scores).all() and err <= 1e-4,
                f"convert_hyperiqa: kind {scorer.kind}, scores {scores}, card vs CPU {err}")
        return {"frames": len(scores), "score_min": min(scores), "score_max": max(scores),
                "card_vs_cpu_rel_err": err}

    def neuralhaircut():
        nh, ckpt, den = upstream_twins.write_neuralhaircut_tree(root)
        npz = os.path.join(root, "strand_prior.npz")
        require(convert_neuralhaircut_ckpt.main([
            "--neuralhaircut_dir", nh, "--strand_ckpt", ckpt, "--diffusion_ckpt", den,
            "--out", npz, "--steps", str(NH_STEPS), "--strand_length", str(STRAND_LEN)]
            + on_dev) == 0,
            "convert_neuralhaircut_ckpt: the conversion failed")
        prior = prior_io.load_prior(npz, STRAND_LEN, DIFF_INPUT, dev)
        require(set(prior) == {"encoder", "decoder", "denoiser"},
                f"convert_neuralhaircut_ckpt: sections {sorted(prior)}")
        # the probe's teacher scene at two views; its config: the full-width
        # defaults at SH degree 1 with the diffusion prior
        probe = s3_lr_probe.build_probe(s3_lr_probe.parse_args(
            ["--ckpt", npz, "--views", "2", "--test_views", "0"]), dev)
        scfg = probe.scfg
        warm = stage2.warm_start(stage2.init_hair_state(scfg, own_denoiser=False, device=dev),
                                 prior)
        require(all(torch.equal(a, b) for a, b in zip(warm.params.decoder.parameters(),
                                                      prior["decoder"].parameters())),
                "convert_neuralhaircut_ckpt: the warm start is not the prior's decoder")
        del warm

        class Scene:
            train_cameras = probe.train_cameras
        metrics = []
        model_cfg = ModelConfig()
        torch.cuda.synchronize()
        before = dict(loader.launches)
        stage2.train(model_cfg, OptimizationConfig(iterations=1, lambda_dmask=0.1,
                                                   lambda_dorient=0.1, lambda_dsds=0.01,
                                                   train_orient_conf=False),
                     scfg, PipelineConfig(), Scene, probe.head_model, probe.pool,
                     float(probe.radius_scale) / model_cfg.strand_scale,
                     checkpoint_iterations=(), denoiser=prior["denoiser"], prior=prior,
                     progress_callback=lambda it, st, m: metrics.append(
                         {k: float(m[k]) for k in ("total", "l1", "sds")}), device=dev)
        torch.cuda.synchronize()
        step = {k: n - before[k] for k, n in loader.launches.items()}
        require(step["raster_fwd"] == 1 and step["raster_bwd"] == 1,
                f"convert_neuralhaircut_ckpt: the stage-2 step launched {step}")
        require(len(metrics) == 1 and all(np.isfinite(v) for v in metrics[0].values()),
                f"convert_neuralhaircut_ckpt: the stage-2 step's losses {metrics}")
        return {"prior_mb": os.path.getsize(npz) / 1e6, "stage2_step": metrics[0],
                "step_launches": step}

    def lr_probe():
        res = s3_lr_probe.main(["--ckpt", ck2, "--iters", str(PROBE_ITERS), "--lrs", PROBE_LRS,
                                "--views", str(PROBE_VIEWS), "--test_views",
                                str(PROBE_TEST_VIEWS), "--sh_degree", "3",
                                "--out", os.path.join(root, "probe.json")] + on_dev)
        flat = [v for r in res.values() for k, v in r.items() if k != "l1_train_hist"]
        flat += [v for r in res.values() for v in r.get("l1_train_hist", [])]
        require(len(res) == 1 + len(PROBE_LRS.split(",")) and np.isfinite(flat).all(),
                f"s3_lr_probe: {res}")
        return res

    part("selftests", selftests)
    part("convert_lpips", lpips)
    expect_launches("convert_lpips", 2, 0)               # cameras 0 and 1
    part("build_scene", build_scene)
    expect_launches("build_scene", E2E_VIEWS, 0)
    part("convert_hyperiqa", hyperiqa)
    part("convert_neuralhaircut_ckpt", neuralhaircut)
    expect_launches("convert_neuralhaircut_ckpt", 2 + 1, 1)     # two views' ground truth, a step
    part("s3_lr_probe", lr_probe)
    # the ground truth at every view, the init and each run's evaluation at
    # the test views, and each run's steps
    n_lrs = len(PROBE_LRS.split(","))
    expect_launches("s3_lr_probe", PROBE_VIEWS + PROBE_TEST_VIEWS + (1 + n_lrs) * PROBE_TEST_VIEWS
                    + n_lrs * PROBE_ITERS, n_lrs * PROBE_ITERS)
    expect_launches("selftests", 0, 0)
    expect_launches("convert_hyperiqa", 0, 0)
    return out


if __name__ == "__main__":
    sys.exit(main())
