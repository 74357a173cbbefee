"""Stage-2/3 quality harness: strand self-reconstruction PSNR and chamfer
(port of ``tools/quality_strands.py``; its JSON keys, those of
``QUALITY_STRANDS_rNN.json``, so that the two records compare line by line).

A procedural strand teacher (wavy polylines grown from a synthetic scalp
over a skin-coloured head ball) is rendered through the forward compositing
kernel as ground truth; stage 2 fits its latent textured-strand generator to
the renders from scratch, stage 3 refines explicit polylines from the
stage-2 output, both through the port's trainers (both kernels).  With
``--use_sds_stage3`` the SDS prior of stage 3 is distilled from the stage-2
strands (``train/prior.distill_strand_prior``).  Runs on CUDA unless
``--device cpu`` is given.

    python3 -m gaussianhaircut_torch.tools.quality_strands [--iters2 3000]
        [--iters3 1000] [--use_diffusion] [--use_sds_stage3] [--out FILE]

``QUALITY_LOG_EVERY=N`` prints losses and it/s every N iterations (and
``--rate_probe`` takes its median rate from them), as in the JAX tool; its
``QUALITY_DUMP_DIR`` is left out (``--ckpt_dir`` keeps the stage-2 state).
``--capacity_mult`` is accepted and has no effect: the port's binning sizes
its instance buffer from ``num_rendered``.  The random streams are the
port's: the tool seeds them as the JAX tool seeds its keys, but the numbers
differ.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.models.strands import strands_to_gaussians
from gaussianhaircut_torch.models.textured_strands import (
    TexturedStrandsConfig, sample_roots, synthetic_scalp_pool,
)
from gaussianhaircut_torch.ops import losses as L
from gaussianhaircut_torch.ops.chamfer import chamfer_distance
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.render.renderer import (
    GaussianFields, default_background, render_fields,
)
from gaussianhaircut_torch.scene.cameras import CameraStatic
from gaussianhaircut_torch.tools.quality_run import geom_of
from gaussianhaircut_torch.train import optim, stage2, stage3
from gaussianhaircut_torch.train.prior import distill_strand_prior, pretrain_strand_decoder


def make_cameras(n_views: int, width: int, height: int, radius: float = 0.55,
                 target=(0.0, 0.07, 0.0)) -> list:
    """A ring of cameras around the scalp cap with an elevation wobble."""
    cams = []
    fov = math.radians(40)
    target = np.asarray(target)
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        el = 0.35 + 0.2 * math.sin(2.7 * a)   # look slightly down at the cap
        center = target + np.array([radius * math.cos(el) * math.sin(a),
                                    radius * math.sin(el),
                                    radius * math.cos(el) * math.cos(a)])
        fwd = target - center
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=0)
        w2c[:3, 3] = -w2c[:3, :3] @ center
        cams.append(CameraStatic(uid=i, colmap_id=i, image_name=f"{i:04d}", width=width,
                                 height=height, colmap_transform=w2c, fovx=fov, fovy=fov))
    return cams


def teacher_strands(pool, n: int, length: int, rng: np.random.Generator, device):
    """Procedural wavy strands: smooth functions of the root uv (learnable
    by a scalp texture) grown along the scalp normal with a world-space
    droop.  Returns (points [N, L, 3], rgb [N, 3], uvs [N, 2] numpy,
    local2world [N, 3, 3]), the tensors float32 on ``device``."""
    idx = rng.choice(pool.origins.shape[0], size=n, replace=False)
    origins = np.asarray(pool.origins)[idx]
    uvs = np.asarray(pool.uvs)[idx]
    l2w = np.asarray(pool.local2world)[idx]          # columns (t, b, n)

    t = np.linspace(0.0, 1.0, length, dtype=np.float32)[None, :]
    seg_len = 0.08
    amp = 0.008 * (0.5 + uvs[:, 1:2])
    phase = 2.0 * np.pi * uvs[:, 0:1]
    # local frame: x tangent wiggle, y bitangent wiggle, z along the normal
    lx = amp * np.sin(4.0 * np.pi * t + phase)
    ly = 0.5 * amp * np.cos(3.0 * np.pi * t + 2.0 * phase)
    lz = np.broadcast_to(seg_len * t, lx.shape)
    local = np.stack([lx, ly, lz], axis=-1)
    world = origins[:, None, :] + np.einsum("nij,nlj->nli", l2w, local)
    world = world - np.stack([np.zeros_like(t), 0.06 * t * t, np.zeros_like(t)], axis=-1)
    # brown, brightness varying smoothly with uv
    base = np.array([0.35, 0.22, 0.12], np.float32)
    rgb = base[None, :] * (0.6 + 0.4 * uvs[:, 0:1]).astype(np.float32)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return f32(world), f32(rgb), uvs, f32(l2w)


def teacher_fields(points, rgb, radius_scale, sh_degree: int) -> GaussianFields:
    """The teacher polylines as segment Gaussians (stage 3's conversion),
    with degree-0 colours."""
    sg = strands_to_gaussians(points, radius_scale)
    n, s = points.shape[0], points.shape[1] - 1
    k = (sh_degree + 1) ** 2
    dev = points.device
    f_dc = ((rgb - 0.5) / 0.28209479177387814)[:, None, None, :]
    features = torch.cat([f_dc.expand(n, s, 1, 3).reshape(n * s, 1, 3),
                          torch.zeros((n * s, k - 1, 3), device=dev)], dim=1)
    ones = torch.ones((n * s, 1), device=dev)
    return GaussianFields(
        xyz=sg.xyz, features=features, scaling=sg.scaling,
        rotation_matrix=sg.rotation_matrix, opacity=ones, label=ones, orient_conf=ones,
        valid=torch.ones(n * s, dtype=torch.bool, device=dev),
        viewspace=torch.zeros((n * s, 3), device=dev),
        use_direction=torch.ones(n * s, device=dev))


def make_head_model(rng: np.random.Generator, capacity: int = 4096, n: int = 2048,
                    device=None, sh_degree: int = 1) -> gm.GaussianModelState:
    """A solid skin-coloured ball under the scalp cap, labelled head, with
    SH coefficients up to ``sh_degree``."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = 0.095 * rng.random(n) ** (1.0 / 3.0)
    pts = (v * r[:, None] + np.array([0, 0.03, 0])).astype(np.float32)
    skin = np.tile(np.array([[0.8, 0.6, 0.5]], np.float32), (n, 1))
    cols = np.clip(skin + rng.normal(scale=0.03, size=(n, 3)), 0, 1)
    state = gm.create_from_pcd(pts, cols.astype(np.float32), capacity, sh_degree, 1.0,
                               device)
    with torch.no_grad():
        state.params.label.fill_(-6.0)          # head rows
        state.params.opacity.fill_(2.0)         # ~0.88: solid
    return state


@torch.no_grad()
def attach_gt(cams, fields: GaussianFields, sh_degree: int, raster_cfg: RasterConfig) -> int:
    """Each camera's ground truth rendered from ``fields`` (one forward
    launch each).  Returns the largest ``num_rendered``."""
    dev = fields.xyz.device
    bg = default_background(False, dev)
    most = 0
    for c in cams:
        out = render_fields(fields, sh_degree, geom_of(c, dev), bg, raster_cfg)
        img, mask, angle = (torch.clamp(out[k], 0.0, 1.0).cpu().numpy()
                            for k in ("render", "mask", "orient_angle"))
        c.image, c.mask_hair, c.mask_body, c.orient_angle = img, mask[:1], mask[1:2], angle
        c.orient_conf = np.ones((1, c.height, c.width), np.float32)
        most = max(most, int(out["num_rendered"]))
    return most


@torch.no_grad()
def evaluate(hair: GaussianFields, head: GaussianFields, cams, name: str,
             sh_degree: int, raster_cfg: RasterConfig) -> dict:
    """PSNR, hair-mask L1 and orientation error against the teacher renders,
    averaged over ``cams`` (one forward launch each)."""
    merged = stage2.concat_fields(head, hair)
    dev = merged.xyz.device
    bg = default_background(False, dev)
    totals = torch.zeros(3, dtype=torch.float64, device=dev)
    for c in cams:
        out = render_fields(merged, sh_degree, geom_of(c, dev), bg, raster_cfg)
        gt_img, gt_hair, gt_angle = (torch.as_tensor(a, device=dev) for a in (
            c.image, c.mask_hair, c.orient_angle))
        totals += torch.stack([
            L.psnr(torch.clamp(out["render"], 0.0, 1.0), gt_img),
            L.l1_loss(torch.clamp(out["mask"][:1], 0, 1), gt_hair),
            L.or_loss(torch.clamp(out["orient_angle"], 0, 1), gt_angle, mask=gt_hair)]).double()
    totals = (totals / len(cams)).cpu().numpy()
    return {f"{name}_psnr": round(float(totals[0]), 3),
            f"{name}_hair_l1": round(float(totals[1]), 5),
            f"{name}_orient": round(float(totals[2]), 5)}


def strand_chamfer(points: torch.Tensor, teacher_flat: torch.Tensor) -> float:
    """Symmetric chamfer (the mean of the sided mean squared distances)
    between the polylines' point cloud and the teacher's."""
    with torch.no_grad():
        return float(chamfer_distance(points.reshape(-1, 3), teacher_flat))


def run_sds_ablation(args, scfg, t_pts, t_uvs, t_l2w, curves_state, chamfer_of,
                     scene, model_cfg, pipe_cfg, head_model, device) -> dict:
    """Does SDS regularize?  A prior distilled from the TEACHER strands; the
    refined strands perturbed with segment noise and recovered on four
    views (the image losses starve) with and without the SDS term."""
    prior, pinfo = distill_strand_prior(t_pts, t_uvs, t_l2w, scfg,
                                        steps=args.ablate_prior_steps, seed=1000,
                                        device=device)
    l0, ln = pinfo["prior_loss_start"], pinfo["prior_loss_end"]
    print(f"# ablation prior: denoiser loss {l0:.4f} -> {ln:.4f} "
          f"({args.ablate_prior_steps} steps)", flush=True)

    dirs = curves_state.params.dirs
    sigma_pert = 0.5 * float(torch.std(dirs))
    gen = torch.Generator(device=device).manual_seed(13)
    noise = sigma_pert * torch.randn(dirs.shape, generator=gen, device=device)
    pert = curves_state.params.replace(dirs=dirs + noise)
    chamfer_pert = chamfer_of(stage3.curves_points(pert, curves_state.static))

    class SparseScene:
        train_cameras = scene.train_cameras[:4]
        test_cameras = scene.test_cameras

    out = {"ablation_prior_loss_start": round(l0, 4), "ablation_prior_loss_end": round(ln, 4),
           "ablation_chamfer_perturbed": chamfer_pert}
    for name, use_sds, lam in (("no_sds", False, 0.0), ("sds", True, args.ablate_lambda_sds)):
        start = stage3.CurvesTrainState(pert, curves_state.static, optim.adam_init(pert), 0)
        with tempfile.TemporaryDirectory() as td:
            ck = os.path.join(td, "pert.npz")
            stage3.save_checkpoint(start, ck)
            opt_cfg = OptimizationConfig(iterations=args.ablate_iters, lambda_dmask=0.1,
                                         lambda_dorient=0.1, lambda_dssim=0.2,
                                         lambda_dsds=lam, train_orient_conf=False)
            rec = stage3.train(model_cfg, opt_cfg, scfg, pipe_cfg, SparseScene, head_model,
                               None, None, scene_scale=1.0, num_strands=args.num_strands,
                               checkpoint_iterations=(), start_checkpoint=ck,
                               prior=prior if use_sds else None, use_sds=use_sds,
                               device=device)
        out[f"ablation_chamfer_{name}"] = chamfer_of(stage3.curves_points(rec.params, rec.static))
        print(f"# ablation {name}: chamfer {chamfer_pert:.3e} -> "
              f"{out[f'ablation_chamfer_{name}']:.3e}", flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser("quality_strands")
    ap.add_argument("--iters2", type=int, default=3000)
    ap.add_argument("--iters3", type=int, default=1000)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--test_views", type=int, default=4)
    ap.add_argument("--teacher_strands", type=int, default=2500)
    ap.add_argument("--num_strands", type=int, default=2000)
    ap.add_argument("--strand_length", type=int, default=16)
    ap.add_argument("--pool_size", type=int, default=20000)
    ap.add_argument("--texture_size", type=int, default=128)
    ap.add_argument("--capacity_mult", type=int, default=12,
                    help="accepted for the JAX tool's command lines; no effect")
    ap.add_argument("--use_diffusion", action="store_true")
    ap.add_argument("--use_sds_stage3", action="store_true",
                    help="distill a prior from the stage-2 generator output "
                    "(train/prior.py) and refine stage 3 with lambda_dsds, as the "
                    "reference does with its pretrained prior (run.sh:195)")
    ap.add_argument("--prior_steps", type=int, default=600)
    ap.add_argument("--lambda_sds3", type=float, default=0.01)
    ap.add_argument("--spatial_lr3", type=float, default=0.0,
                    help="stage-3 spatial_lr_scale; 0 = the camera extent bounded "
                    "by stage3.stable_spatial_lr_scale")
    ap.add_argument("--ckpt_dir", default="",
                    help="directory for periodic stage-2/3 checkpoints")
    ap.add_argument("--ckpt_every", type=int, default=1000)
    ap.add_argument("--resume2", default="", help="stage-2 checkpoint npz to resume from")
    ap.add_argument("--resume3", default="", help="stage-3 checkpoint npz to resume from")
    ap.add_argument("--ablate_sds", action="store_true",
                    help="distill a prior from the TEACHER strands, perturb the "
                    "refined strands and compare chamfer recovery with and "
                    "without SDS")
    ap.add_argument("--ablate_iters", type=int, default=600)
    ap.add_argument("--ablate_prior_steps", type=int, default=400)
    ap.add_argument("--ablate_lambda_sds", type=float, default=0.05)
    ap.add_argument("--warm_start", type=int, default=0,
                    help="pretrain the strand decoder for N steps on the teacher "
                    "strands and warm-start stage 2 from it; 0 = cold start")
    ap.add_argument("--out", default="")
    ap.add_argument("--rate_probe", action="store_true",
                    help="exit after stage 2 and record its steady-state it/s (median "
                    "of the QUALITY_LOG_EVERY intervals past the first) into "
                    "--out's stage2_iters_per_sec if the file exists")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(args) -> dict | None:
    """The harness; returns the JSON record (None after ``--rate_probe``)."""
    device = resolve_device(args.device)
    res = args.res
    rng = np.random.default_rng(0)
    pool = synthetic_scalp_pool(args.pool_size)
    radius_scale = torch.tensor(6e-4, device=device)
    scfg = TexturedStrandsConfig(num_strands=args.num_strands, texture_size=args.texture_size,
                                 strand_length=args.strand_length, sh_degree=1,
                                 pool_size=args.pool_size, use_diffusion=args.use_diffusion)

    t_pts, t_rgb, t_uvs, t_l2w = teacher_strands(pool, args.teacher_strands,
                                                 args.strand_length, rng, device)
    hair_t = teacher_fields(t_pts, t_rgb, radius_scale, scfg.sh_degree)
    head_model = make_head_model(rng, device=device)
    head = stage2.make_head_fields(head_model)
    raster_cfg = RasterConfig()
    cams = make_cameras(args.views + args.test_views, res, res)
    most = attach_gt(cams, stage2.concat_fields(head, hair_t), scfg.sh_degree, raster_cfg)
    print(f"# GT rendered (max num_rendered {most})", flush=True)

    class Scene:
        train_cameras = cams[:args.views]
        test_cameras = cams[args.views:]

    model_cfg = ModelConfig()
    pipe_cfg = PipelineConfig()
    # aleatoric confidence off, as in quality_run
    opt2 = OptimizationConfig(iterations=args.iters2, lambda_dmask=0.1, lambda_dorient=0.1,
                              lambda_dsds=0.01, train_orient_conf=False)
    log_every = int(os.environ.get("QUALITY_LOG_EVERY", 0))
    scene_scale = float(radius_scale) / model_cfg.strand_scale

    prior2, warm_info = None, {}
    if args.warm_start:
        prior2, warm_info = pretrain_strand_decoder(t_pts, t_l2w, scfg, steps=args.warm_start,
                                                    seed=2024, device=device)
        print(f"# warm_start: decoder pretrain loss {warm_info['decoder_pretrain_loss_start']} "
              f"-> {warm_info['decoder_pretrain_loss_end']} ({args.warm_start} steps)",
              flush=True)

    cb_t = [time.time()]
    interval_rates = []
    gnorm_max = [0.0]

    def cb2(it, state, metrics):
        # sampled at the logging cadence only: a float() syncs the card
        if log_every and it % log_every == 0:
            if "grad_norm" in metrics:
                gnorm_max[0] = max(gnorm_max[0], float(metrics["grad_norm"]))
            now = time.time()
            dt, cb_t[0] = now - cb_t[0], now
            interval_rates.append(log_every / max(dt, 1e-9))
            print(f"# s2 it={it} total={float(metrics['total']):.4f} "
                  f"l1={float(metrics['l1']):.4f} nr={metrics['num_rendered']} "
                  f"({interval_rates[-1]:.2f} it/s)", flush=True)

    ckpt2 = ckpt3 = ()
    if args.ckpt_dir and args.ckpt_every:
        ckpt2 = tuple(range(args.ckpt_every, args.iters2 + 1, args.ckpt_every))
        ckpt3 = tuple(range(args.ckpt_every, args.iters3 + 1, args.ckpt_every))
    t0 = time.time()
    hair_state = stage2.train(
        model_cfg, opt2, scfg, pipe_cfg, Scene, head_model, pool, scene_scale,
        model_path_hair=os.path.join(args.ckpt_dir, "stage2") if args.ckpt_dir else "",
        checkpoint_iterations=ckpt2, start_checkpoint=args.resume2 or None,
        prior=prior2, progress_callback=cb2 if log_every else None, device=device)
    _sync(device)
    dt2 = time.time() - t0
    print(f"# stage2: {args.iters2} iters in {dt2:.1f}s ({args.iters2 / dt2:.2f} it/s)",
          flush=True)
    if args.rate_probe:
        rate = (float(np.median(interval_rates[1:])) if len(interval_rates) > 1
                else args.iters2 / dt2)
        print(f"# rate_probe: stage2 steady {rate:.3f} it/s", flush=True)
        if args.out and os.path.exists(args.out):
            with open(args.out) as f:
                d = json.load(f)
            d["stage2_iters_per_sec"] = round(rate, 3)
            d["stage2_rate_source"] = (
                f"fresh {args.iters2}-iter steady-state probe (--rate_probe, median of "
                f"{max(len(interval_rates) - 1, 0)} post-warmup intervals)")
            with open(args.out, "w") as f:
                json.dump(d, f, indent=1)
            print(f"# rate_probe: wrote stage2_iters_per_sec to {args.out}", flush=True)
        return None
    pool_d = pool.to(device)
    eval_roots = sample_roots(pool_d, scfg.num_strands,
                              torch.Generator(device=device).manual_seed(42))
    with torch.no_grad():
        hair2, _ = stage2.hair_fields_from_strands(hair_state.params, pool_d, scfg,
                                                   eval_roots, radius_scale)
    report = {}
    for name, cs in (("stage2_train", Scene.train_cameras), ("stage2_test", Scene.test_cameras)):
        report.update(evaluate(hair2, head, cs, name, scfg.sh_degree, raster_cfg))
    print(f"# stage2 eval: {report}", flush=True)
    del hair2

    # ---- stage 3: refine explicit polylines from the stage-2 generator ----
    t_flat = t_pts.reshape(-1, 3)
    chamfer_of = lambda pts: strand_chamfer(pts, t_flat)
    # the trainer's own roots (stage3.train), so that the before/after
    # compare the same frozen origins
    roots = sample_roots(pool, args.num_strands, torch.Generator().manual_seed(1))
    params0, static0 = stage3.create_from_stage2(hair_state.params, pool_d, scfg,
                                                 roots.to(device))
    pts0 = stage3.curves_points(params0, static0)
    with torch.no_grad():
        report.update(evaluate(stage3.curves_fields(params0, static0, scfg, radius_scale),
                               head, Scene.test_cameras, "stage3_init_test",
                               scfg.sh_degree, raster_cfg))
    report["stage3_init_chamfer"] = chamfer_of(pts0)

    # SDS in the main stage-3 path (train_strands.py:128-147, lambda_sds 0.01
    # at run.sh:195): the prior is distilled from the stage-2 strands
    prior3 = None
    if args.use_sds_stage3:
        t0 = time.time()
        prior3, pinfo3 = distill_strand_prior(pts0, static0.uvs, static0.local2world, scfg,
                                              steps=args.prior_steps, seed=2000, device=device)
        print(f"# stage3 prior: denoiser loss {pinfo3['prior_loss_start']} -> "
              f"{pinfo3['prior_loss_end']} ({args.prior_steps} steps, "
              f"{time.time() - t0:.0f}s)", flush=True)
        report.update({f"stage3_{k}": v for k, v in pinfo3.items()})

    opt3 = OptimizationConfig(iterations=args.iters3, lambda_dmask=0.1, lambda_dorient=0.1,
                              lambda_dssim=0.2, lambda_dsds=args.lambda_sds3,
                              train_orient_conf=False)
    spatial_lr3 = args.spatial_lr3
    if spatial_lr3 <= 0:
        # the reference's camera radius (train_strands.py:49), bounded by the
        # stability limit of the cumsum-dirs parameterization
        centers = np.stack([-c.colmap_transform[:3, :3].T @ c.colmap_transform[:3, 3]
                            for c in cams])
        extent = float(1.1 * np.max(np.linalg.norm(centers - centers.mean(0), axis=-1)))
        seg = float(torch.linalg.norm(t_pts[:, 1:] - t_pts[:, :-1], dim=-1).mean())
        spatial_lr3 = stage3.stable_spatial_lr_scale(opt3, seg, extent)
        print(f"# stage3 spatial_lr_scale(auto) = {spatial_lr3:.4f} (extent {extent:.4f})",
              flush=True)

    cb3_t = [time.time()]

    def cb3(it, st, metrics):
        if log_every and it % log_every == 0:
            now = time.time()
            dt, cb3_t[0] = now - cb3_t[0], now
            delta = float(torch.abs(st.params.dirs - params0.dirs).max())
            print(f"# s3 it={it} total={float(metrics['total']):.4f} "
                  f"l1={float(metrics['l1']):.4f} sds={float(metrics.get('sds', 0)):.4f} "
                  f"finite={float(metrics['grads_finite']):.0f} "
                  f"nr={metrics['num_rendered']} max|d dirs|={delta:.3e} "
                  f"({log_every / max(dt, 1e-9):.2f} it/s)", flush=True)

    t0 = time.time()
    curves_state = stage3.train(
        model_cfg, opt3, scfg, pipe_cfg, Scene, head_model, hair_state.params, pool,
        scene_scale, num_strands=args.num_strands,
        model_path_curves=os.path.join(args.ckpt_dir, "stage3") if args.ckpt_dir else "",
        checkpoint_iterations=ckpt3, start_checkpoint=args.resume3 or None,
        prior=prior3, use_sds=args.use_sds_stage3, spatial_lr_scale=spatial_lr3,
        progress_callback=cb3 if log_every else None, device=device)
    _sync(device)
    dt3 = time.time() - t0
    print(f"# stage3: {args.iters3} iters in {dt3:.1f}s ({args.iters3 / dt3:.2f} it/s)",
          flush=True)

    with torch.no_grad():
        hair3 = stage3.curves_fields(curves_state.params, curves_state.static, scfg,
                                     radius_scale)
    for name, cs in (("stage3_train", Scene.train_cameras), ("stage3_test", Scene.test_cameras)):
        report.update(evaluate(hair3, head, cs, name, scfg.sh_degree, raster_cfg))
    report["stage3_chamfer"] = chamfer_of(stage3.curves_points(curves_state.params,
                                                               curves_state.static))
    print(f"# stage3 chamfer {report['stage3_init_chamfer']:.3e} -> "
          f"{report['stage3_chamfer']:.3e}", flush=True)

    if args.ablate_sds:
        report.update(run_sds_ablation(args, scfg, t_pts, t_uvs, t_l2w, curves_state,
                                       chamfer_of, Scene, model_cfg, pipe_cfg, head_model,
                                       device))
    return {
        "config": {"res": res, "views": args.views, "test_views": args.test_views,
                   "teacher_strands": args.teacher_strands, "num_strands": args.num_strands,
                   "strand_length": args.strand_length, "iters2": args.iters2,
                   "iters3": args.iters3, "use_diffusion": args.use_diffusion,
                   "use_sds_stage3": args.use_sds_stage3, "lambda_sds3": args.lambda_sds3,
                   "texture_size": args.texture_size, "backend": device.type},
        **report,
        # a --resume2 checkpoint skips stage-2 training: no rate
        "stage2_iters_per_sec": None if args.resume2 else round(args.iters2 / dt2, 3),
        "stage3_iters_per_sec": round(args.iters3 / dt3, 3),
        "warm_start": bool(args.warm_start),
        **warm_info,
        **({"stage2_grad_norm_max": round(gnorm_max[0], 3)} if gnorm_max[0] > 0 else {}),
    }


def main(argv=None) -> dict | None:
    args = parse_args(argv)
    result = run(args)
    if result is not None:
        print(json.dumps(result), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
