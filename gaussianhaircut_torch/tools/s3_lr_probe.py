"""Stage-3 learning-rate sweep at the reference operating point (port of
``tools/s3_lr_probe.py``; its flags and JSON keys).

Loads a stage-2 checkpoint once, builds the synthetic teacher scene of
``tools/quality_strands`` (ground truth rendered by the forward compositing
kernel), then runs several short stage-3 refinements with different
``spatial_lr_scale`` values (optionally with SDS) to find the largest dirs lr
whose image loss still descends and whose chamfer does not drift: the
cumsum-dirs parameterization moves tip points by up to (L - 1) x lr per Adam
step.  Every stage-3 step launches both compositing kernels, every render
of the ground truth and the evaluations the forward.

The JSON: ``init`` (test PSNR, hair L1 and chamfer of the stage-3 state made
from the checkpoint), then one entry per ``lr=<lr>[+sds]`` with
``test_psnr``, ``hair_l1``, ``chamfer``, ``l1_train_hist`` (every 20
iterations) and ``it_per_sec``.  ``--sh_degree`` (default 1, the JAX tool's
fixed value) must be the checkpoint's; ``--capacity_mult`` is accepted and
has no effect (the port sizes its instance buffer from ``num_rendered``).
The stage-3 roots are drawn as ``stage3.train`` draws them.  Runs on CUDA
unless ``--device cpu`` is given.

    python3 -m gaussianhaircut_torch.tools.s3_lr_probe \\
        --ckpt runs/r4/ckpt2/stage2/checkpoints/20000.npz --iters 300 --lrs 0.2,0.06,0.02
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models.textured_strands import (
    TexturedStrandsConfig, sample_roots, synthetic_scalp_pool,
)
from gaussianhaircut_torch.ops import losses as L
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.render.renderer import default_background, render_fields
from gaussianhaircut_torch.tools import quality_strands as QS
from gaussianhaircut_torch.tools.quality_run import geom_of
from gaussianhaircut_torch.train import stage2, stage3
from gaussianhaircut_torch.train.prior import distill_strand_prior


@dataclasses.dataclass
class Probe:
    """The teacher scene with its ground truth: what every run shares."""
    scfg: TexturedStrandsConfig
    pool: object
    teacher_points: torch.Tensor       # [T, L, 3]
    head_model: object
    head: object
    train_cameras: list
    test_cameras: list
    radius_scale: torch.Tensor
    device: torch.device

    def chamfer(self, points: torch.Tensor) -> float:
        return QS.strand_chamfer(points, self.teacher_points.reshape(-1, 3))


def build_probe(args, device) -> Probe:
    """The scene of ``tools/quality_strands`` from numpy's
    ``default_rng(0)``, its ground truth rendered at every camera."""
    rng = np.random.default_rng(0)
    pool = synthetic_scalp_pool(args.pool_size)
    radius_scale = torch.tensor(6e-4, device=device)
    scfg = TexturedStrandsConfig(num_strands=args.num_strands, texture_size=args.texture_size,
                                 strand_length=args.strand_length, sh_degree=args.sh_degree,
                                 pool_size=args.pool_size, use_diffusion=True)
    t_pts, t_rgb, _, _ = QS.teacher_strands(pool, args.teacher_strands, args.strand_length,
                                            rng, device)
    hair_t = QS.teacher_fields(t_pts, t_rgb, radius_scale, scfg.sh_degree)
    head_model = QS.make_head_model(rng, device=device, sh_degree=scfg.sh_degree)
    head = stage2.make_head_fields(head_model)
    cams = QS.make_cameras(args.views + args.test_views, args.res, args.res)
    t0 = time.time()
    QS.attach_gt(cams, stage2.concat_fields(head, hair_t), scfg.sh_degree, RasterConfig())
    print(f"# GT rendered in {time.time() - t0:.0f}s", flush=True)
    return Probe(scfg, pool, t_pts, head_model, head, cams[:args.views], cams[args.views:],
                 radius_scale, device)


def initial_state(ckpt: str, probe: Probe, roots: torch.Tensor):
    """(stage-2 parameters from ``ckpt``, the stage-3 parameters and static
    record made from them at the pool entries ``roots``).  A denoiser in the
    checkpoint is not loaded: stage 3 does not use it."""
    template = stage2.init_hair_state(probe.scfg, own_denoiser=False, device=probe.device)
    hair_params = stage2.load_checkpoint(ckpt, template).params
    print(f"# stage2 checkpoint loaded: {ckpt}", flush=True)
    with torch.no_grad():
        params0, static0 = stage3.create_from_stage2(hair_params, probe.pool.to(probe.device),
                                                     probe.scfg, roots.to(probe.device))
    return hair_params, params0, static0


@torch.no_grad()
def evaluate(probe: Probe, params, static, cams) -> tuple[float, float]:
    """(PSNR, hair-mask L1) against the ground truth, averaged over ``cams``
    and rounded as the JAX tool rounds them; one forward launch per camera."""
    fields = stage3.curves_fields(params, static, probe.scfg, probe.radius_scale)
    merged = stage2.concat_fields(probe.head, fields)
    bg = default_background(False, probe.device)
    tot = torch.zeros(2, dtype=torch.float64, device=probe.device)
    for c in cams:
        out = render_fields(merged, probe.scfg.sh_degree, geom_of(c, probe.device), bg,
                            RasterConfig())
        gt_img, gt_hair = (torch.as_tensor(a, device=probe.device)
                           for a in (c.image, c.mask_hair))
        tot += torch.stack([L.psnr(torch.clamp(out["render"], 0.0, 1.0), gt_img),
                            L.l1_loss(torch.clamp(out["mask"][:1], 0, 1), gt_hair)]).double()
    tot = (tot / len(cams)).cpu().numpy()
    return round(float(tot[0]), 3), round(float(tot[1]), 5)


def run_lr(probe: Probe, hair_params, lr: float, iters: int, prior=None,
           use_sds: bool = False) -> dict:
    """One stage-3 refinement at ``spatial_lr_scale = lr`` from the
    checkpoint's stage-2 parameters -> its JSON entry."""
    model_cfg = ModelConfig()
    opt3 = OptimizationConfig(iterations=iters, lambda_dmask=0.1, lambda_dorient=0.1,
                              lambda_dssim=0.2, lambda_dsds=0.01 if use_sds else 0.0,
                              train_orient_conf=False)
    l1_hist = []

    def cb(it, st, metrics):
        if it % 20 == 0:
            l1_hist.append(round(float(metrics["l1"]), 5))

    class Scene:
        train_cameras = probe.train_cameras
        test_cameras = probe.test_cameras

    QS._sync(probe.device)
    t0 = time.time()
    st = stage3.train(model_cfg, opt3, probe.scfg, PipelineConfig(), Scene, probe.head_model,
                      hair_params, probe.pool,
                      scene_scale=float(probe.radius_scale) / model_cfg.strand_scale,
                      num_strands=probe.scfg.num_strands, checkpoint_iterations=(),
                      spatial_lr_scale=lr, prior=prior if use_sds else None, use_sds=use_sds,
                      progress_callback=cb, device=probe.device)
    QS._sync(probe.device)
    dt = time.time() - t0
    with torch.no_grad():
        chamfer = probe.chamfer(stage3.curves_points(st.params, st.static))
    psnr, l1 = evaluate(probe, st.params, st.static, probe.test_cameras)
    return {"test_psnr": psnr, "hair_l1": l1, "chamfer": chamfer, "l1_train_hist": l1_hist,
            "it_per_sec": round(iters / dt, 2)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser("s3_lr_probe")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--lrs", default="0.2,0.06,0.02")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--test_views", type=int, default=4)
    ap.add_argument("--num_strands", type=int, default=10000)
    ap.add_argument("--teacher_strands", type=int, default=10000)
    ap.add_argument("--strand_length", type=int, default=100)
    ap.add_argument("--pool_size", type=int, default=20000)
    ap.add_argument("--texture_size", type=int, default=256)
    ap.add_argument("--capacity_mult", type=int, default=5,
                    help="accepted for the JAX tool's command lines; no effect")
    ap.add_argument("--sds", action="store_true", help="also run each lr with the SDS prior on")
    ap.add_argument("--prior_steps", type=int, default=600)
    ap.add_argument("--sh_degree", type=int, default=1,
                    help="the checkpoint's SH degree (its colour decoder's width)")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    probe = build_probe(args, device)
    # the roots stage3.train draws, so that init and the runs start alike
    roots = sample_roots(probe.pool, args.num_strands, torch.Generator().manual_seed(1))
    hair_params, params0, static0 = initial_state(args.ckpt, probe, roots)
    with torch.no_grad():
        chamfer0 = probe.chamfer(stage3.curves_points(params0, static0))
    psnr0, l1_0 = evaluate(probe, params0, static0, probe.test_cameras)
    print(f"# init: test_psnr={psnr0} hair_l1={l1_0} chamfer={chamfer0:.3e}", flush=True)

    prior3 = None
    if args.sds:
        with torch.no_grad():
            pts0 = stage3.curves_points(params0, static0)
        prior3, pinfo3 = distill_strand_prior(pts0, static0.uvs, static0.local2world,
                                              probe.scfg, steps=args.prior_steps, seed=2000,
                                              device=device)
        print(f"# prior distilled: {pinfo3}", flush=True)
    del params0, static0

    results = {"init": {"test_psnr": psnr0, "hair_l1": l1_0, "chamfer": chamfer0}}
    for lr in [float(x) for x in args.lrs.split(",")]:
        for use_sds in ([False, True] if args.sds else [False]):
            tag = f"lr={lr}{'+sds' if use_sds else ''}"
            results[tag] = run_lr(probe, hair_params, lr, args.iters, prior3, use_sds)
            r = results[tag]
            print(f"# {tag}: test_psnr {psnr0}->{r['test_psnr']} chamfer "
                  f"{chamfer0:.3e}->{r['chamfer']:.3e} l1_hist={r['l1_train_hist']}",
                  flush=True)

    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
