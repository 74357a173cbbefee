"""Render trained stage-1 Gaussians for train/test views and export the
synthetic-GT set consumed by stages 2/3 (port of ``gaussianhaircut_tpu/cli/
render_gaussians.py``; reference src/render_gaussians.py:31-130).

    python3 -m gaussianhaircut_torch.cli.render_gaussians -s SCENE -m MODEL [...]

Outputs per view under <model>/<split><suffix>/ours_<iter>/:
  renders/ hair_masks/ head_masks/ orients/ orients_vis/ orient_confs/(npy)
  orient_confs_vis/
plus cameras/<iter>_matrices.pkl + _params.pkl when cameras are trainable.
Each view is one render (one launch of the compositing forward kernel).
Runs on the GPU; ``--device cpu`` runs the plain PyTorch path on the CPU.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from gaussianhaircut_torch import config as cfg_mod
from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.render.renderer import default_background, render
from gaussianhaircut_torch.scene.cameras import CameraBatch, CameraResiduals, camera_geom
from gaussianhaircut_torch.scene.dataset import fov2focal, load_scene
from gaussianhaircut_torch.utils.image import save_image, vis_orient


def find_max_iteration(model_path: str, sub: str = "point_cloud") -> int:
    root = os.path.join(model_path, sub)
    iters = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("iteration_")]
    return max(iters)


def find_head_ply(model_path: str, iteration: int, explicit: str = "") -> str:
    """The frozen-head point cloud for stages 2/3: prefer the FLAME-filtered
    cloud (run.sh:151-153), fall back to the raw stage-1 save."""
    if explicit:
        return explicit
    candidates = [
        os.path.join(model_path, sub, f"iteration_{iteration}", name)
        for sub in ("point_cloud_filtered", "point_cloud")
        for name in ("raw_point_cloud.ply", "point_cloud.ply")]
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"no head point cloud under {model_path} "
                            f"(tried {candidates})")


def load_camera_residuals(model_path: str, iteration: int, cams, device=None):
    """Residuals of ``cameras/<iteration>.pkl`` stacked in ``cams`` order
    (cameras missing from the pickle keep the identity residual); None when
    there is no pickle."""
    pkl_path = os.path.join(model_path, "cameras", f"{iteration}.pkl")
    if not os.path.exists(pkl_path):
        return None
    with open(pkl_path, "rb") as f:
        rot, trans, fov = pickle.load(f)
    r0 = next(iter(rot.values()))
    res = CameraResiduals.create(len(cams), np.asarray(r0).shape[-1] == 3, "cpu")
    rot_a, tr_a, fov_a = (t.numpy().copy() for t in res.values())
    for i, c in enumerate(cams):
        if c.image_name in rot:
            rot_a[i] = np.asarray(rot[c.image_name])
            tr_a[i] = np.asarray(trans[c.image_name])
        if c.image_name in fov and len(fov):
            fov_a[i] = np.asarray(fov[c.image_name])
    dev = resolve_device(device)
    return CameraResiduals(*(torch.as_tensor(a, device=dev) for a in (rot_a, tr_a, fov_a)))


def render_set(model_path, split_name, iteration, cams, model_state, residuals,
               model_cfg, raster_cfg, scene_suffix=""):
    if not cams:
        return
    base = os.path.join(model_path, f"{split_name}{scene_suffix}", f"ours_{iteration}")
    dirs = {k: os.path.join(base, k) for k in
            ("renders", "hair_masks", "head_masks", "orients", "orients_vis",
             "orient_confs", "orient_confs_vis")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    device = model_state.params.xyz.device
    cam_batch = CameraBatch.from_cameras(cams, device)
    bg = default_background(model_cfg.white_background, device)
    width, height = cams[0].width, cams[0].height
    for i, cam in enumerate(cams):
        with torch.no_grad():
            geom = camera_geom(
                cam_batch.colmap_transform[i], cam_batch.fovx[i], cam_batch.fovy[i],
                width, height, residuals, i, use_barf=model_cfg.use_barf,
                trainable_cameras=model_cfg.trainable_cameras and residuals is not None,
                trainable_intrinsics=model_cfg.trainable_intrinsics and residuals is not None)
            out = render(model_state.params, model_state.aux.alive,
                         model_state.max_sh_degree, geom, bg, raster_cfg)
        image, mask, orient_angle, orient_conf = (
            out[k].cpu().numpy() for k in ("render", "mask", "orient_angle", "orient_conf"))
        hair_mask = mask[:1]
        head_mask = mask[1:]
        masked_angle = orient_angle * hair_mask
        conf = orient_conf * hair_mask
        name = os.path.basename(cam.image_name).split(".")[0]
        save_image(image, os.path.join(dirs["renders"], name + ".png"))
        save_image(hair_mask, os.path.join(dirs["hair_masks"], name + ".png"))
        save_image(head_mask, os.path.join(dirs["head_masks"], name + ".png"))
        save_image(masked_angle, os.path.join(dirs["orients"], name + ".png"))
        save_image(vis_orient(orient_angle, hair_mask),
                   os.path.join(dirs["orients_vis"], name + ".png"))
        np.save(os.path.join(dirs["orient_confs"], name + ".npy"), conf)
        save_image(vis_orient(orient_angle, 1 - 1 / (conf + 1)),
                   os.path.join(dirs["orient_confs_vis"], name + ".png"))


def export_camera_matrices(model_path, iteration, cams, residuals, model_cfg):
    """cameras/<iter>_matrices.pkl + _params.pkl (render_gaussians.py:85-97),
    numpy arrays and Python numbers only."""
    device = residuals.fov.device
    cam_batch = CameraBatch.from_cameras(cams, device)
    matrices, params = {}, {}
    with torch.no_grad():
        for i, c in enumerate(cams):
            geom = camera_geom(cam_batch.colmap_transform[i], cam_batch.fovx[i],
                               cam_batch.fovy[i], c.width, c.height, residuals, i,
                               use_barf=model_cfg.use_barf)
            fovx = float(cam_batch.fovx[i] + residuals.fov[i][0])
            fovy = float(cam_batch.fovy[i] + residuals.fov[i][1])
            matrices[c.image_name] = geom.projmatrix.cpu().numpy()
            params[c.image_name] = {
                "fx": fov2focal(fovx, c.width),
                "fy": fov2focal(fovy, c.height),
                "width": c.width,
                "height": c.height,
                "Rt": geom.viewmatrix.cpu().numpy().T,
            }
    os.makedirs(os.path.join(model_path, "cameras"), exist_ok=True)
    with open(os.path.join(model_path, "cameras", f"{iteration}_matrices.pkl"), "wb") as f:
        pickle.dump(matrices, f)
    with open(os.path.join(model_path, "cameras", f"{iteration}_params.pkl"), "wb") as f:
        pickle.dump(params, f)


def main(argv=None):
    parser = argparse.ArgumentParser("render_gaussians")
    cfg_mod.add_model_args(parser)
    cfg_mod.add_pipeline_args(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--data_dir", default="", type=str)
    parser.add_argument("--scene_suffix", default="", type=str)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--pointcloud_path", default="", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (cpu runs the plain "
                        "PyTorch path)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model_cfg = cfg_mod.extract(cfg_mod.ModelConfig, args)
    pipe_cfg = cfg_mod.extract(cfg_mod.PipelineConfig, args)
    if args.data_dir:
        model_cfg.source_path = os.path.abspath(args.data_dir)

    iteration = args.iteration
    if iteration == -1:
        iteration = find_max_iteration(model_cfg.model_path)

    scene = load_scene(model_cfg, load_gt=False)
    ply_path = args.pointcloud_path or os.path.join(
        model_cfg.model_path, f"point_cloud{args.scene_suffix}",
        f"iteration_{iteration}", "raw_point_cloud.ply")
    model_state = gm.load_ply(ply_path, 0, model_cfg.sh_degree, device=device)

    residuals = None
    if model_cfg.trainable_cameras:
        residuals = load_camera_residuals(model_cfg.model_path, iteration,
                                          scene.train_cameras, device)
        if residuals is not None:
            export_camera_matrices(model_cfg.model_path, iteration,
                                   scene.train_cameras, residuals, model_cfg)

    raster_cfg = RasterConfig(tile_w=pipe_cfg.tile, tile_h=pipe_cfg.tile)
    if not args.skip_train:
        render_set(model_cfg.model_path, "train", iteration,
                   scene.train_cameras, model_state, residuals, model_cfg,
                   raster_cfg, args.scene_suffix)
    if not args.skip_test:
        render_set(model_cfg.model_path, "test", iteration, scene.test_cameras,
                   model_state, residuals, model_cfg, raster_cfg,
                   args.scene_suffix)


if __name__ == "__main__":
    main()
