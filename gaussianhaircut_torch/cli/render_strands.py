"""Render the refined strands over the frozen head for the scene's cameras
(port of ``gaussianhaircut_tpu/cli/render_strands.py``; reference
src/render_strands.py:32-152, the same output layout).

    python3 -m gaussianhaircut_torch.cli.render_strands -s SCENE -m MODEL \\
        --model_hair_path HAIR --checkpoint_curves CURVES/checkpoints/<it>.npz

Writes per view under ``<model_hair_path>/<split><suffix>/ours_<iter>/``:
renders/ hair_masks/ head_masks/ orients/ orients_vis/ orient_confs/ (npy)
orient_confs_vis/.  Each view is one render, one launch of the compositing
forward kernel.  Runs on the GPU; ``--device cpu`` runs the plain PyTorch
path on the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gaussianhaircut_torch import config as cfg_mod
from gaussianhaircut_torch.utils.image import save_image, vis_orient


def render_hair_set(model_hair_path, split_name, iteration, cams, head, hair_fields,
                    model_cfg, raster_cfg, residuals, scene_suffix="") -> None:
    from gaussianhaircut_torch.render.renderer import default_background, render_fields
    from gaussianhaircut_torch.scene.cameras import CameraBatch, camera_geom
    from gaussianhaircut_torch.train.stage2 import concat_fields

    if not cams:
        return
    base = os.path.join(model_hair_path, f"{split_name}{scene_suffix}", f"ours_{iteration}")
    dirs = {k: os.path.join(base, k) for k in
            ("renders", "hair_masks", "head_masks", "orients", "orients_vis",
             "orient_confs", "orient_confs_vis")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    device = head.xyz.device
    cam_batch = CameraBatch.from_cameras(cams, device)
    bg = default_background(model_cfg.white_background, device)
    width, height = cams[0].width, cams[0].height
    fields = concat_fields(head, hair_fields)
    for i, cam in enumerate(cams):
        with torch.no_grad():
            # the JAX CLI leaves use_barf at camera_geom's default
            geom = camera_geom(cam_batch.colmap_transform[i], cam_batch.fovx[i],
                               cam_batch.fovy[i], width, height, residuals, i,
                               trainable_cameras=residuals is not None,
                               trainable_intrinsics=residuals is not None)
            out = render_fields(fields, model_cfg.sh_degree, geom, bg, raster_cfg)
        image, mask, orient_angle, orient_conf = (
            out[k].cpu().numpy() for k in ("render", "mask", "orient_angle", "orient_conf"))
        hair_mask = mask[:1]
        name = os.path.basename(cam.image_name).split(".")[0]
        save_image(image, os.path.join(dirs["renders"], name + ".png"))
        save_image(hair_mask, os.path.join(dirs["hair_masks"], name + ".png"))
        save_image(mask[1:], os.path.join(dirs["head_masks"], name + ".png"))
        save_image(orient_angle * hair_mask, os.path.join(dirs["orients"], name + ".png"))
        save_image(vis_orient(orient_angle, hair_mask),
                   os.path.join(dirs["orients_vis"], name + ".png"))
        conf = orient_conf * hair_mask
        np.save(os.path.join(dirs["orient_confs"], name + ".npy"), conf)
        save_image(vis_orient(orient_angle, 1 - 1 / (conf + 1)),
                   os.path.join(dirs["orient_confs_vis"], name + ".png"))


def main(argv=None) -> None:
    from gaussianhaircut_torch.cli.render_gaussians import (
        find_head_ply, find_max_iteration, load_camera_residuals)
    from gaussianhaircut_torch.cli.train_latent_strands import load_scene_scale
    from gaussianhaircut_torch.device import resolve_device
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.models.textured_strands import TexturedStrandsConfig
    from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
    from gaussianhaircut_torch.scene.dataset import load_scene
    from gaussianhaircut_torch.train import stage3
    from gaussianhaircut_torch.train.stage2 import make_head_fields

    parser = argparse.ArgumentParser("render_strands")
    cfg_mod.add_model_args(parser)
    cfg_mod.add_pipeline_args(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[-1],
                        help="accepted for a trainer-compatible invocation; rendering "
                        "has no test evaluation")
    parser.add_argument("--data_dir", type=str, default="")
    parser.add_argument("--model_hair_path", type=str, required=True)
    parser.add_argument("--checkpoint_curves", type=str, required=True)
    parser.add_argument("--pointcloud_path_head", type=str, default="")
    parser.add_argument("--scene_suffix", default="", type=str)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (cpu runs the plain "
                        "PyTorch path)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model_cfg = cfg_mod.extract(cfg_mod.ModelConfig, args)
    pipe_cfg = cfg_mod.extract(cfg_mod.PipelineConfig, args)
    if args.data_dir:
        model_cfg.source_path = os.path.abspath(args.data_dir)

    scene = load_scene(model_cfg, load_gt=False)
    iteration = args.iteration
    if iteration == -1:
        iteration = find_max_iteration(model_cfg.model_path)

    head_ply = find_head_ply(model_cfg.model_path, iteration, args.pointcloud_path_head)
    head = make_head_fields(gm.load_ply(head_ply, 0, model_cfg.sh_degree, device=device))

    curves = stage3.load_checkpoint(args.checkpoint_curves, device)
    scfg = TexturedStrandsConfig(sh_degree=model_cfg.sh_degree)
    radius_scale = torch.tensor(model_cfg.strand_scale * load_scene_scale(model_cfg.source_path),
                                dtype=torch.float32, device=device)
    with torch.no_grad():
        hair_fields = stage3.curves_fields(curves.params, curves.static, scfg, radius_scale)

    residuals = (load_camera_residuals(model_cfg.model_path, iteration,
                                       scene.train_cameras, device)
                 if model_cfg.trainable_cameras else None)
    raster_cfg = RasterConfig(tile_w=pipe_cfg.tile, tile_h=pipe_cfg.tile)
    if not args.skip_train:
        render_hair_set(args.model_hair_path, "train", iteration, scene.train_cameras,
                        head, hair_fields, model_cfg, raster_cfg, residuals,
                        args.scene_suffix)
    if not args.skip_test:
        render_hair_set(args.model_hair_path, "test", iteration, scene.test_cameras,
                        head, hair_fields, model_cfg, raster_cfg, residuals,
                        args.scene_suffix)


if __name__ == "__main__":
    main()
