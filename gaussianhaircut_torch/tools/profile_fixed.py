"""Split the compositing forward's time into its fixed per-chunk cost and
its pair maths, on one GPU.

    python3 -m gaussianhaircut_torch.tools.profile_fixed [--reps 20]

The counterpart of section H of ``tools/tpu_profile_r4.py``.  At the bench
kernel shapes (the bench scene's camera 0, 100k slots, SH degree 3 active,
32x32 tiles, chunk 256) it times with CUDA events, in turns:

- ``raster_fwd``: the compositing forward kernel;
- ``raster_probe``: the forward's skeleton (staging, barriers, vote, flush)
  with trivial maths (``csrc/raster_probe.cu``);
- ``raster_probe_grid_only``: the skeleton without staging or payload reads.

Prints one JSON line: the three median times, ``pair_math_ms`` = forward -
probe, ``staging_ms`` = probe - grid only, and the card's name and power
limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from gaussianhaircut_torch.ops.rasterize import common as C
from gaussianhaircut_torch.ops.rasterize import cuda_core


def nvidia_smi() -> str:
    """The card's name and power limit, one line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        times.append(_event_ms(fn))
    return statistics.median(times)


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def binned_inputs(params, alive, sh_degree: int, scene, cam_idx: int,
                  cfg: C.RasterConfig, device):
    """Render inputs of one camera, preprocessed and binned (no autograd).
    Returns (binned, a function that bins again)."""
    from gaussianhaircut_torch.render.renderer import fields_from_params
    with torch.no_grad():
        return binned_fields(fields_from_params(params, alive), sh_degree,
                             scene_camera(scene, cam_idx, device), cfg)


def scene_camera(scene, cam_idx: int, device):
    """Camera ``cam_idx`` of a scene, without residuals."""
    from gaussianhaircut_torch.scene.cameras import CameraBatch, camera_geom
    cams = scene.train_cameras
    cb = CameraBatch.from_cameras(cams, device)
    return camera_geom(cb.colmap_transform[cam_idx], cb.fovx[cam_idx], cb.fovy[cam_idx],
                       cams[cam_idx].width, cams[cam_idx].height, None)


@torch.no_grad()
def binned_fields(fields, sh_degree: int, cam, cfg: C.RasterConfig):
    """Activated fields seen by ``cam``, preprocessed and binned.  Returns
    (binned, a function that bins again)."""
    from gaussianhaircut_torch.ops.rasterize.api import ndc_xy_to_pixel
    from gaussianhaircut_torch.render.renderer import prepare_raster_inputs
    ndc, conic, colors, opacity, depth, valid = prepare_raster_inputs(
        fields, sh_degree, cam)
    mean_pix = ndc_xy_to_pixel(ndc, cam.width, cam.height)

    def binning():
        pre = C.preprocess(mean_pix, conic, depth, valid, cam.width, cam.height, cfg,
                           opacity=opacity)
        return C.bin_instances(pre, mean_pix, conic, opacity, colors, depth,
                               cam.width, cam.height, cfg)
    return binning(), binning


def bench_binned(device, cfg: C.RasterConfig):
    """The bench kernel shapes: camera 0 of the bench scene, slot capacity =
    the 100k points, SH degree 3 active."""
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.scene.synthetic import bench_scene
    scene = bench_scene()
    model = gm.create_from_pcd(scene.points, scene.colors, len(scene.points), 3,
                               scene.cameras_extent, device)
    binned, _ = binned_inputs(model.params, model.aux.alive, 3, scene, 0, cfg,
                              device)
    cam = scene.train_cameras[0]
    return binned, cam.width, cam.height


def measure(binned, width: int, height: int, cfg: C.RasterConfig,
            reps: int = 20, warmup: int = 2) -> dict:
    """Median CUDA-event times of the forward, the probe and the grid-only
    probe on one binned layout, timed in turns (one of each per round)."""
    lay = (binned.payload, binned.chunk_start, binned.nchunks, width, height, cfg)
    fns = {
        "fwd_ms": lambda: cuda_core.raster_fwd(*lay),
        "probe_ms": lambda: cuda_core.raster_probe(*lay),
        "grid_only_ms": lambda: cuda_core.raster_probe(*lay, grid_only=True),
    }
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            times[k].append(_event_ms(fn))
    out = {k: statistics.median(v) for k, v in times.items()}
    out["pair_math_ms"] = out["fwd_ms"] - out["probe_ms"]
    out["staging_ms"] = out["probe_ms"] - out["grid_only_ms"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    from gaussianhaircut_torch.device import resolve_device
    dev = resolve_device(None)
    cfg = C.RasterConfig(tile_w=32, tile_h=32, chunk=256)
    binned, width, height = bench_binned(dev, cfg)
    res = measure(binned, width, height, cfg, reps=args.reps)
    res.update(device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi(),
               tiles=binned.num_tiles, chunks_used=int(binned.nchunks.sum()),
               num_rendered=binned.num_rendered, reps=args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
