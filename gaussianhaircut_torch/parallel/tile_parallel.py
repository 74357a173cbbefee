"""Tile-row sharding of each camera's render, with camera data parallelism
(port of ``gaussianhaircut_tpu/parallel/tile_parallel.py``).

Each rank of a camera's ``tile`` group renders a window of whole tile rows
of the image, ``rasterize(..., full_height=H, row0=y0)``, so binning and
both compositing kernels see only the window.  The windows are gathered
into the full image on every rank of the group and the losses are taken
replicated on it, the same as on one device (SSIM windows across the seams
included).  The per-Gaussian precompute
stays replicated.

Gradients: a rank's backward covers its own rows, so the Gaussian gradients
are summed over ``tile`` and then averaged over ``data``; the camera rows
are summed over both.  Visibility and radii are maxed over ``tile``, then
the densify statistics go over ``data`` as in ``data_parallel``.

Two differences from the JAX package, both to make a window the
single-device render's rows bit for bit (the ulps of a shifted NDC move
alpha tests and early stops, and Adam turns a gradient that appears or
vanishes into a step of its own):
- the window keeps the image's pixel coordinates and its grid starts at
  row y0 (``rasterize``'s ``row0``, which binning and both kernels take),
  where JAX shifts NDC by -2*y0/H;
- the last window stops at the image's last tile row.  JAX renders the
  whole ``crop_h`` there, rows past the image included, and counts a
  Gaussian seen only in those rows as visible; here the windows partition
  the single-device step's tile grid, so visibility and radii are the
  single-device step's.  A window that starts below the image renders
  nothing.
"""
from __future__ import annotations

import torch

from gaussianhaircut_torch.config import OptimizationConfig
from gaussianhaircut_torch.ops.rasterize.api import rasterize
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.parallel import collectives as coll
from gaussianhaircut_torch.parallel.data_parallel import reduce_and_update
from gaussianhaircut_torch.parallel.mesh import Mesh
from gaussianhaircut_torch.render.renderer import (
    decode_render10, default_background, fields_from_params, prepare_raster_inputs)
from gaussianhaircut_torch.scene.cameras import camera_geom
from gaussianhaircut_torch.train import stage1


def row_windows(height: int, tile_h: int, n_tile: int) -> tuple[int, list]:
    """(crop_h, [(y0, rows)] per tile rank): windows of ``crop_h`` rows, a
    whole number of tile rows each, the last ones cut at the image."""
    rows_per = -(-(-(-height // tile_h)) // n_tile)
    crop_h = rows_per * tile_h
    return crop_h, [(t * crop_h, max(0, min(crop_h, height - t * crop_h)))
                    for t in range(n_tile)]


def render_window(params, alive, active_sh_degree, cam, bg, raster_cfg, y0: int,
                  rows: int, crop_h: int, height: int):
    """Rows [y0, y0 + rows) of the camera's [10, H, W] render, zero-padded
    to ``crop_h`` rows -> (window, radii, visibility, num_rendered)."""
    fields = fields_from_params(params, alive)
    n = fields.xyz.shape[0]
    if rows == 0:
        window = torch.zeros((10, crop_h, cam.width), device=fields.xyz.device)
        return (window, torch.zeros(n, dtype=torch.int32, device=window.device),
                torch.zeros(n, dtype=torch.bool, device=window.device), 0)
    ndc, conic, colors, opacity, depth, valid = prepare_raster_inputs(
        fields, active_sh_degree, cam)
    out = rasterize(ndc, conic, colors, opacity, depth, valid, bg, cam.width, rows,
                    raster_cfg, full_height=height, row0=y0)
    window = torch.nn.functional.pad(out["render"], (0, 0, 0, crop_h - rows))
    return window, out["radii"], out["visibility"], out["num_rendered"]


def dp_tp_train_step(mesh: Mesh, *, active_sh_degree: int, width: int, height: int,
                     raster_cfg: RasterConfig, opt_cfg: OptimizationConfig,
                     trainable_cameras: bool = True, trainable_intrinsics: bool = True,
                     use_barf: bool = True, white_background: bool = False):
    """The 2-D (camera x tile-row) step.

    Returns ``step(state, cam_batch, gt, cam_idxs) -> (state, metrics)``:
    ``cam_idxs`` holds one camera per data rank, the same list on every
    rank.  The rank at (d, t) renders rows ``row_windows(...)[1][t]`` of
    camera ``cam_idxs[d]``; metrics are ``stage1.train_step``'s, the loss
    terms averaged over cameras and ``num_rendered`` the largest window's."""
    crop_h, windows = row_windows(height, raster_cfg.tile_h, mesh.n_tile)
    y0, rows = windows[mesh.tile_index]

    def step(state, cam_batch, gt, cam_idxs):
        idx = int(cam_idxs[mesh.data_index])
        bg = default_background(white_background, mesh.device)
        alive = state.model.aux.alive

        def forward(params, cam_res):
            cam = camera_geom(cam_batch.colmap_transform[idx], cam_batch.fovx[idx],
                              cam_batch.fovy[idx], width, height, cam_res, idx,
                              use_barf=use_barf, trainable_cameras=trainable_cameras,
                              trainable_intrinsics=trainable_intrinsics)
            window, radii, vis, num_rendered = render_window(
                params, alive, active_sh_degree, cam, bg, raster_cfg, y0, rows, crop_h,
                height)
            render10 = coll.gather_rows(mesh, window) if mesh.n_tile > 1 else window
            dec = decode_render10(render10[:, :height])
            loss, parts = stage1.compute_losses(dec, gt.image[idx], gt.mask[idx],
                                                gt.orient_angle[idx], gt.orient_conf[idx],
                                                opt_cfg)
            return loss, (parts, radii, vis, num_rendered)

        gparams, gcam, (parts, radii, vis, num_rendered) = stage1.step_grads(state, forward)
        if mesh.n_tile > 1:
            # rows are disjoint: the whole camera's gradients are the sum over
            # the tile group; visible anywhere in the camera = visible
            like = gparams.values() + gcam.values() + [vis.to(torch.float32)]
            red = coll.unflatten(coll.all_reduce(mesh, coll.flatten(like), "tile", "sum"),
                                 like)
            n_p = len(gparams.values())
            gparams = type(gparams)(*red[:n_p])
            gcam = type(gcam)(*red[n_p:-1])
            vis = red[-1] > 0
        return reduce_and_update(
            mesh, state, gparams, gcam, vis, radii, parts, num_rendered, cam_idxs,
            opt_cfg=opt_cfg, trainable_cameras=trainable_cameras,
            trainable_intrinsics=trainable_intrinsics)

    return step
