"""Novel-view video export (port of ``gaussianhaircut_tpu/cli/render_video.py``;
reference src/postprocessing/render_video.py): interpolate a smooth camera
path through the optimized cameras, render the reconstruction along it,
write the video, and export the Blender hand-off bundle for offline Cycles
strand rendering.

    python3 -m gaussianhaircut_torch.cli.render_video -s SCENE -m MODEL [--num_frames 150]

Each frame is one render (one launch of the compositing forward kernel)
under ``torch.no_grad()``, saved as ``video_frames/<i>.png``; the video is
``video.avi`` (PNG frames in an AVI, see ``postprocessing/video.py``) where
the JAX package writes ``video.mp4``.  As in the JAX CLI, the path runs
through the dataset cameras as loaded: the trained camera residuals are not
applied.  Runs on the GPU; ``--device cpu`` runs the plain PyTorch path on
the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gaussianhaircut_torch import config as cfg_mod
from gaussianhaircut_torch.cli.render_gaussians import find_max_iteration
from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.postprocessing.video import (
    export_blender_inputs, interpolate_camera_path, write_video)
from gaussianhaircut_torch.render.renderer import default_background, render
from gaussianhaircut_torch.scene.cameras import camera_geom
from gaussianhaircut_torch.scene.dataset import fov2focal, load_scene
from gaussianhaircut_torch.utils.image import save_image


def camera_path(cams, num_frames: int) -> list:
    """World-to-camera float32 [4, 4] matrices of ``num_frames`` frames on
    a smooth path through every ``len(cams) // 12``-th camera."""
    keys = list(range(0, len(cams), max(1, len(cams) // 12)))
    rots = np.stack([cams[i].colmap_transform[:3, :3] for i in keys])
    trans = np.stack([cams[i].colmap_transform[:3, 3] for i in keys])
    samples = np.linspace(0, len(keys) - 1, num_frames)
    r_path, t_path = interpolate_camera_path(rots, trans, np.arange(len(keys)), samples)
    path = []
    for r, t in zip(r_path, t_path):
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = r
        w2c[:3, 3] = t
        path.append(w2c)
    return path


def render_frame(model_state, w2c: np.ndarray, fovx: float, fovy: float,
                 width: int, height: int, bg: torch.Tensor,
                 raster_cfg: RasterConfig) -> torch.Tensor:
    """The [3, H, W] render of one path camera."""
    dev = model_state.params.xyz.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    with torch.no_grad():
        geom = camera_geom(torch.as_tensor(w2c, device=dev), f32(fovx), f32(fovy),
                           width, height)
        return render(model_state.params, model_state.aux.alive,
                      model_state.max_sh_degree, geom, bg, raster_cfg)["render"]


def main(argv=None):
    parser = argparse.ArgumentParser("render_video")
    cfg_mod.add_model_args(parser)
    cfg_mod.add_pipeline_args(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--num_frames", default=150, type=int)
    parser.add_argument("--fps", default=30, type=int)
    parser.add_argument("--strands_pkl", default="", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (cpu runs the plain "
                        "PyTorch path)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model_cfg = cfg_mod.extract(cfg_mod.ModelConfig, args)
    pipe_cfg = cfg_mod.extract(cfg_mod.PipelineConfig, args)
    iteration = args.iteration if args.iteration != -1 else \
        find_max_iteration(model_cfg.model_path)

    scene = load_scene(model_cfg, load_gt=False)
    cams = scene.train_cameras
    state = gm.load_ply(os.path.join(
        model_cfg.model_path, "point_cloud", f"iteration_{iteration}",
        "raw_point_cloud.ply"), 0, model_cfg.sh_degree, device=device)

    path = camera_path(cams, args.num_frames)
    width, height = cams[0].width, cams[0].height
    fovx, fovy = cams[0].fovx, cams[0].fovy
    raster_cfg = RasterConfig(tile_w=pipe_cfg.tile, tile_h=pipe_cfg.tile)
    bg = default_background(model_cfg.white_background, device)

    frames_dir = os.path.join(model_cfg.model_path, "video_frames")
    os.makedirs(frames_dir, exist_ok=True)
    blender_cams = {}
    for i, w2c in enumerate(path):
        img = render_frame(state, w2c, fovx, fovy, width, height, bg, raster_cfg)
        save_image(img.cpu().numpy(), os.path.join(frames_dir, f"{i:06d}.png"))
        blender_cams[f"{i:06d}"] = {
            "Rt": w2c, "width": width, "height": height,
            "fx": fov2focal(fovx, width), "fy": fov2focal(fovy, height)}

    write_video(frames_dir, os.path.join(model_cfg.model_path, "video.avi"), args.fps)
    if args.strands_pkl:
        export_blender_inputs(
            os.path.join(model_cfg.model_path, "blender_inputs"),
            blender_cams, args.strands_pkl,
            os.path.join(model_cfg.model_path, "point_cloud",
                         f"iteration_{iteration}", "point_cloud.ply"))


if __name__ == "__main__":
    main()
