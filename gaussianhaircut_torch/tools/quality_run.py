"""Stage-1 quality harness (port of ``tools/quality_run.py``): fit stage 1
to ground truth rendered from a held-out teacher model and report train and
test PSNR, L1, an LPIPS and the held-out curve, under the JAX tool's JSON
keys (``QUALITY_rNN.json``), so that the two records compare line by line.

The teacher is a seeded Gaussian blob; its renders go through the forward
compositing kernel, and the student trains with the port's ``stage1.train``
(both kernels).  Runs on CUDA unless ``--device cpu`` is given.

    python3 -m gaussianhaircut_torch.tools.quality_run [--iters 3000]
        [--teacher_p 20000] [--res 256] [--views 20] [--test_views 4]
        [--eval_every 3000] [--out QUALITY.json] [--device cpu]

``QUALITY_LOG_EVERY=N`` prints the loss and the alive count every N
iterations, as the JAX tool does.  ``--capacity_mult`` is accepted for the
JAX tool's command lines and has no effect: the port's binning sizes its
instance buffer from ``num_rendered`` on every call.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.ops.lpips import lpips_or_none
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.render.renderer import default_background, render
from gaussianhaircut_torch.scene.cameras import CameraBatch, CameraStatic, camera_geom
from gaussianhaircut_torch.train import stage1
from gaussianhaircut_torch.train.stage1 import GtBatch


def make_cameras(n_views: int, width: int, height: int, radius: float = 2.5) -> list:
    """A ring of cameras around the origin with an elevation wobble that
    breaks the ring's symmetry (the JAX tool's ``make_cameras``)."""
    cams = []
    fov = math.radians(50)
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        el = 0.25 * math.sin(3.1 * a)
        center = np.array([radius * math.cos(el) * math.sin(a),
                           radius * math.sin(el) + 0.3,
                           radius * math.cos(el) * math.cos(a)])
        fwd = -center / np.linalg.norm(center)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=0)
        w2c[:3, 3] = -w2c[:3, :3] @ center
        cams.append(CameraStatic(uid=i, colmap_id=i, image_name=f"{i:04d}", width=width,
                                 height=height, colmap_transform=w2c, fovx=fov, fovy=fov))
    return cams


def teacher_and_student_init(p: int):
    """The JAX tool's draws from ``default_rng(0)``: the teacher's points
    and colours, then the student's initial points (the teacher's with 0.02
    positional noise) and its neutral colours."""
    rng = np.random.default_rng(0)
    pts = rng.normal(scale=0.3, size=(p, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(p, 3)).astype(np.float32)
    init = pts + rng.normal(scale=0.02, size=pts.shape).astype(np.float32)
    return pts, cols, init, np.full_like(cols, 0.5)


def geom_of(cam: CameraStatic, device):
    """The camera's projection on ``device``, without residuals."""
    return camera_geom(torch.as_tensor(cam.colmap_transform, device=device),
                       torch.tensor(cam.fovx, device=device),
                       torch.tensor(cam.fovy, device=device), cam.width, cam.height)


@torch.no_grad()
def render_gt(model: gm.GaussianModelState, cam: CameraStatic, raster_cfg: RasterConfig):
    """(image [3, H, W], mask [2, H, W], orientation angle [1, H, W]) of
    ``model`` at ``cam``, each clipped to [0, 1]: one forward launch."""
    device = model.params.xyz.device
    out = render(model.params, model.aux.alive, 3, geom_of(cam, device),
                 default_background(False, device), raster_cfg)
    return tuple(torch.clamp(out[k], 0.0, 1.0) for k in ("render", "mask", "orient_angle"))


def attach_gt(cams, model: gm.GaussianModelState, raster_cfg: RasterConfig) -> None:
    """Each camera's ground truth rendered from the teacher ``model``."""
    for c in cams:
        img, mask, angle = (t.cpu().numpy() for t in render_gt(model, c, raster_cfg))
        c.image, c.mask_hair, c.mask_body, c.orient_angle = img, mask[:1], mask[1:2], angle
        c.orient_conf = np.ones((1, c.height, c.width), np.float32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser("quality_run")
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--teacher_p", type=int, default=20000)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--test_views", type=int, default=4)
    ap.add_argument("--capacity_mult", type=int, default=8,
                    help="accepted for the JAX tool's command lines; no effect")
    ap.add_argument("--gaussian_capacity_mult", type=int, default=4,
                    help="slot headroom over the init count; exhausted slots "
                    "stall splitting and leave big blurry gaussians")
    ap.add_argument("--out", default="")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="test and train PSNR on this interval (the held-out curve)")
    ap.add_argument("--save_state", default="",
                    help="write the final TrainState npz here (post-mortem)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The harness; returns the JSON record."""
    device = resolve_device(args.device)
    res, p = args.res, args.teacher_p
    pts, cols, init_pts, init_cols = teacher_and_student_init(p)
    teacher = gm.create_from_pcd(pts, cols, p, 3, 1.0, device)
    raster_cfg = RasterConfig()
    cams = make_cameras(args.views + args.test_views, res, res)
    attach_gt(cams, teacher, raster_cfg)
    print("# GT rendered", flush=True)

    class Scene:
        train_cameras = cams[:args.views]
        test_cameras = cams[args.views:]
        # the student starts from the teacher's (SfM-like) point cloud with
        # positional noise and neutral colours
        points = init_pts
        colors = init_cols
        cameras_extent = 1.0

    model_cfg = ModelConfig(trainable_cameras=False, trainable_intrinsics=False)
    # train_orient_conf off: on self-consistent synthetic GT the aleatoric
    # -log(conf) term is an unbounded reward the optimizer farms at the
    # image's expense
    opt_cfg = OptimizationConfig(iterations=args.iters, lambda_dorient=0.1,
                                 train_orient_conf=False, densify_until_iter=args.iters // 2)
    pipe_cfg = PipelineConfig(gaussian_capacity=args.gaussian_capacity_mult * p)
    eval_cfg = RasterConfig(tile_w=pipe_cfg.tile, tile_h=pipe_cfg.tile)
    log_every = int(os.environ.get("QUALITY_LOG_EVERY", 0))

    batches = {name: (cs, CameraBatch.from_cameras(cs, device), GtBatch.from_cameras(cs, device))
               for name, cs in (("train", Scene.train_cameras), ("test", Scene.test_cameras))}

    def evaluate(state, name, indices, sh_degree):
        cs, cb, gt = batches[name]
        return stage1.evaluate(state, cs, cb, gt, indices, active_sh_degree=sh_degree,
                               width=res, height=res, raster_cfg=eval_cfg,
                               model_cfg=model_cfg, name=name)

    # the held-out curve: (iter, test PSNR, train PSNR, alive) every
    # --eval_every iterations, so that overfitting shows in the record
    curve = []

    def progress(it, state, metrics):
        if log_every and it % log_every == 0:
            print(f"# it={it} total={float(metrics['total']):.4f} "
                  f"ok={bool(metrics['grads_ok'])} "
                  f"xyz_fin={bool(torch.isfinite(state.model.params.xyz).all())} "
                  f"scl_max={float(state.model.params.scaling.max()):.2f} "
                  f"alive={state.model.num_alive()}", flush=True)
        if args.eval_every and it % args.eval_every == 0:
            sh_deg = min(it // 1000, 3)
            te = evaluate(state, "test", range(args.test_views), sh_deg)
            tr = evaluate(state, "train", [i % args.views for i in range(5, 30, 5)], sh_deg)
            curve.append({"iter": it, "test_psnr": round(float(te["test_psnr"]), 3),
                          "train_psnr": round(float(tr["train_psnr"]), 3),
                          "alive": state.model.num_alive()})
            print(f"# curve {curve[-1]}", flush=True)

    t0 = time.time()
    state = stage1.train(model_cfg, opt_cfg, pipe_cfg, Scene, test_iterations=(),
                         save_iterations=(), checkpoint_iterations=(), device=device,
                         progress_callback=progress if (log_every or args.eval_every)
                         else None)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    if args.save_state:
        stage1.save_checkpoint(state, args.save_state)
    print(f"# trained {args.iters} iters in {dt:.1f}s ({args.iters / dt:.2f} it/s)", flush=True)

    report = {}
    for name in ("train", "test"):
        report.update(evaluate(state, name, range(len(batches[name][0])), 3))
    # LPIPS on the test views; an untrained backbone is labelled by its kind
    lp = lpips_or_none(allow_untrained=True, device=device)
    lpips_vals = [float(lp(render_gt(state.model, c, raster_cfg)[0],
                           torch.as_tensor(np.clip(c.image, 0, 1), device=device)))
                  for c in Scene.test_cameras]
    lpips_key = "test_lpips" if lp.kind == "pretrained" else "test_lpips_uncalibrated"
    return {
        "config": {"teacher_p": p, "res": res, "views": args.views,
                   "test_views": args.test_views, "iters": args.iters,
                   "backend": device.type},
        "train_psnr": round(float(report["train_psnr"]), 3),
        "test_psnr": round(float(report["test_psnr"]), 3),
        "train_l1": round(float(report["train_l1"]), 5),
        "test_l1": round(float(report["test_l1"]), 5),
        lpips_key: round(float(np.mean(lpips_vals)), 5),
        "lpips_kind": lp.kind,
        "iters_per_sec": round(args.iters / dt, 3),
        "num_alive": state.model.num_alive(),
        **({"heldout_curve": curve} if curve else {}),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    result = run(args)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
