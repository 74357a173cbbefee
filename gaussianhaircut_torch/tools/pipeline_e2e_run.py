"""Full-length pipeline record (port of ``tools/pipeline_e2e_run.py``; the
keys of ``PIPELINE_r05.json``): the run.sh-shaped reconstruction (stage 1
30k -> stage 2 20k -> stage 3 10k at images_2 = 512 px, 10,000 strands of
100 points, run.sh:110-195) driven end to end through
``cli/run_pipeline.py`` on a scene on disk, every stage timed.

``build_scene`` fabricates the scene at 1024 px from a strand and head
teacher (``tools/quality_strands``), rendered through the forward
compositing kernel, one launch per view: the PNG views, the hair / body /
face masks from the teacher's own alpha (the pluggable-contract posture of
run.sh toward its external networks), the COLMAP text model and a noisy
init cloud, from the JAX tool's numpy draws.  ``main`` then runs
``python -m gaussianhaircut_torch.cli.run_pipeline --data_path SCENE`` and
takes each stage's seconds from its ``=== <stage>: done ===`` lines.  Runs on
CUDA unless ``--device cpu`` is given (then passed on to the pipeline).

    python3 -m gaussianhaircut_torch.tools.pipeline_e2e_run [--out runs/PIPELINE.json]
        [--scene runs/pipeline_scene] [--views 24] [--res 1024]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models.textured_strands import synthetic_scalp_pool
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.render.renderer import default_background, render_fields
from gaussianhaircut_torch.scene import colmap as colmap_io
from gaussianhaircut_torch.tools.quality_run import geom_of
from gaussianhaircut_torch.tools.quality_strands import (
    make_cameras, make_head_model, teacher_fields, teacher_strands,
)
from gaussianhaircut_torch.train import stage2
from gaussianhaircut_torch.utils.image import write_png

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DONE = re.compile(r"=== (\S+): done ===")


def _u8(x: np.ndarray) -> np.ndarray:
    """[0, 1] floats to 8 bits, truncated as the JAX tool does."""
    return (np.asarray(x) * 255).astype(np.uint8)


@torch.no_grad()
def build_scene(scene: str, views: int, res: int, n_strands: int, length: int,
                seed: int = 0, device=None) -> dict:
    """Write the teacher scene under ``scene``: ``images/``,
    ``masks/{hair,face,body}/``, ``sparse/0/{cameras,images,points3D}.txt``.
    Returns the largest ``num_rendered`` and the init cloud's size."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pool = synthetic_scalp_pool(20000)
    t_pts, t_rgb, _, _ = teacher_strands(pool, n_strands, length, rng, device)
    radius_scale = torch.tensor(6e-4, device=device)
    hair_t = teacher_fields(t_pts, t_rgb, radius_scale, 1)
    head_model = make_head_model(rng, device=device)
    fields_gt = stage2.concat_fields(stage2.make_head_fields(head_model), hair_t)
    bg = default_background(False, device)
    cams = make_cameras(views, res, res)

    os.makedirs(f"{scene}/sparse/0", exist_ok=True)
    for sub in ("images", "masks/hair", "masks/face", "masks/body"):
        os.makedirs(f"{scene}/{sub}", exist_ok=True)
    fov = float(cams[0].fovx)
    focal = res / (2 * math.tan(fov / 2))
    colmap_io.write_cameras_text(
        f"{scene}/sparse/0/cameras.txt",
        {1: colmap_io.ColmapCamera(1, "PINHOLE", res, res,
                                   np.array([focal, focal, res / 2, res / 2]))})
    imgs = {}
    max_nr = 0
    for i, c in enumerate(cams):
        out = render_fields(fields_gt, 1, geom_of(c, device), bg, RasterConfig())
        max_nr = max(max_nr, int(out["num_rendered"]))
        img, mask = (torch.clamp(out[k], 0, 1).cpu().numpy() for k in ("render", "mask"))
        name = f"{i:06d}.png"
        write_png(f"{scene}/images/{name}", _u8(img.transpose(1, 2, 0)))
        hair_a, body_a = _u8(mask[0]), _u8(mask[1])
        write_png(f"{scene}/masks/hair/{name}", hair_a)
        write_png(f"{scene}/masks/body/{name}", body_a)
        # face = body minus hair (soft)
        write_png(f"{scene}/masks/face/{name}",
                  np.clip(body_a.astype(np.int32) - hair_a.astype(np.int32), 0, 255)
                  .astype(np.uint8))
        w2c = np.asarray(c.colmap_transform)
        imgs[i + 1] = colmap_io.ColmapImage(i + 1, colmap_io.rotmat_to_qvec(w2c[:3, :3]),
                                            w2c[:3, 3], 1, name)
    colmap_io.write_images_text(f"{scene}/sparse/0/images.txt", imgs)

    # SfM-like init cloud: the head's points and a subsample of the strands', noisy
    head_pts = head_model.params.xyz[head_model.aux.alive].cpu().numpy()
    strand_pts = t_pts.reshape(-1, 3).cpu().numpy()
    k = min(25000, strand_pts.shape[0])
    sel = rng.choice(strand_pts.shape[0], size=k, replace=False)
    cloud = np.concatenate([head_pts, strand_pts[sel]], axis=0)
    cloud = cloud + rng.normal(scale=2e-3, size=cloud.shape)
    with open(f"{scene}/sparse/0/points3D.txt", "w") as f:
        f.write("# points\n# \n# \n")
        for j, p in enumerate(cloud):
            f.write(f"{j} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 128 128 128 0.5\n")
    print(f"# scene built: {views} views @ {res}px, teacher {n_strands}x"
          f"L{length}, GT max num_rendered {max_nr}, init cloud "
          f"{cloud.shape[0]}", flush=True)
    return {"max_num_rendered": max_nr, "init_cloud": int(cloud.shape[0])}


def stage_seconds(lines, clock=time.time, log=None) -> dict:
    """{stage: seconds} from ``run_pipeline``'s ``=== <stage>: done ===``
    lines, each stage timed from the previous line's (or the first call of
    ``clock``); every line is also written to ``log`` when given."""
    times = {}
    last = clock()
    for line in lines:
        if log is not None:
            log.write(line)
            log.flush()
        m = _DONE.match(line)
        if m:
            now = clock()
            times[m.group(1)] = round(now - last, 1)
            last = now
            print(f"# stage {m.group(1)}: {times[m.group(1)]}s", flush=True)
    return times


def record(args, rc: int, stage_t: dict, total: float, log_path: str) -> dict:
    """The run's record under ``PIPELINE_r05.json``'s keys."""
    return {
        "config": {"views": args.views, "res_raw": args.res, "res_train": args.res // 2,
                   "teacher_strands": args.teacher_strands,
                   "strand_length": args.strand_length, "iters": [30000, 20000, 10000],
                   "num_strands": 10000},
        "returncode": rc,
        "stage_seconds": stage_t,
        "total_seconds": round(total, 1),
        "total_hours": round(total / 3600, 2),
        "log": log_path,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser("pipeline_e2e_run")
    ap.add_argument("--scene", default=os.path.join("runs", "pipeline_scene"))
    ap.add_argument("--out", default=os.path.join("runs", "PIPELINE.json"))
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--teacher_strands", type=int, default=10000)
    ap.add_argument("--strand_length", type=int, default=100)
    ap.add_argument("--skip_build", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if not args.skip_build and not os.path.exists(f"{args.scene}/sparse/0/images.txt"):
        t0 = time.time()
        build_scene(args.scene, args.views, args.res, args.teacher_strands,
                    args.strand_length, device=device)
        print(f"# scene build: {time.time() - t0:.0f}s", flush=True)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-u", "-m", "gaussianhaircut_torch.cli.run_pipeline",
           "--data_path", args.scene]
    if args.device is not None:
        cmd += ["--device", str(device)]
    log_path = os.path.join(os.path.dirname(args.scene) or ".", "pipeline_run.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    t_start = time.time()
    with open(log_path, "w") as logf, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) as proc:
        stage_t = stage_seconds(proc.stdout, log=logf)
        rc = proc.wait()
    result = record(args, rc, stage_t, time.time() - t_start, log_path)
    print(json.dumps(result))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
