"""Stage-1 trainer: unstructured 3DGS fit (port of
``gaussianhaircut_tpu/train/stage1.py``; reference train_gaussians.py).

One train step = render -> losses -> backward -> NaN-guarded Adam on the
Gaussian parameters and on the drawn camera's pose/intrinsics residual row.
Densification and opacity resets run on the interval schedule.

Loss stack (train_gaussians.py:120-140):
  loss = lambda_dl1 * L1(render, gt | body-mask)
       + lambda_dssim * (1 - SSIM(masked))
       + lambda_dmask * L1(mask2, gt_mask2)
       + lambda_dorient * OR(orient_angle | conf, weighted by gt conf, hair-mask)

Ported: the single-camera step, the batched-camera step
(``train_step_batched``: B cameras in one launch of each compositing
kernel), the loop around them with the live viewer's poll, evaluation, PLY
and npz checkpoints (the JAX package's key names, so each package reads the
other's) and the camera pickles stages 2 and 3 read, and the multi-device
mesh step behind ``mesh_spec`` (``parallel/``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import random
import time

import numpy as np
import torch

from gaussianhaircut_torch import kernels
from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.ops import losses as L
from gaussianhaircut_torch.ops import projection as proj
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.ops.ssim import ssim
from gaussianhaircut_torch.render import network_gui
from gaussianhaircut_torch.render.renderer import (
    default_background, fields_from_params, render, render_fields_batched)
from gaussianhaircut_torch.scene.cameras import CameraBatch, CameraResiduals, camera_geom
from gaussianhaircut_torch.train import densify, optim
from gaussianhaircut_torch.utils.image import vis_orient
from gaussianhaircut_torch.utils.logger import MetricsLogger


@dataclasses.dataclass
class CamAdamState:
    """Per-camera-row Adam: a camera's row steps only when it is drawn."""
    mu: CameraResiduals
    nu: CameraResiduals
    count: torch.Tensor  # [N] int32


@dataclasses.dataclass
class TrainState:
    model: gm.GaussianModelState
    opt: optim.AdamState
    cam_res: CameraResiduals
    cam_opt: CamAdamState
    step: int


@dataclasses.dataclass
class GtBatch:
    """Ground truth for all training cameras [N, C, H, W]."""
    image: torch.Tensor
    mask: torch.Tensor          # [N, 2, H, W] (hair, body)
    orient_angle: torch.Tensor
    orient_conf: torch.Tensor

    @staticmethod
    def from_cameras(cams, device) -> "GtBatch":
        t = lambda name: torch.as_tensor(
            np.stack([getattr(c, name) for c in cams]).astype(np.float32),
            device=device)
        return GtBatch(image=t("image"), mask=t("mask"),
                       orient_angle=t("orient_angle"), orient_conf=t("orient_conf"))


def param_lrs(opt_cfg: OptimizationConfig, spatial_lr_scale: float,
              step: int) -> gm.GaussianParams:
    """Per-leaf learning rates (gaussian_model.py:426-448): xyz on the
    exponential schedule, viewspace frozen (a gradient port only)."""
    xyz_lr = optim.expon_lr(step, opt_cfg.position_lr_init * spatial_lr_scale,
                            opt_cfg.position_lr_final * spatial_lr_scale,
                            lr_delay_mult=opt_cfg.position_lr_delay_mult,
                            max_steps=opt_cfg.position_lr_max_steps)
    return gm.GaussianParams(
        xyz=xyz_lr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr,
        label=opt_cfg.label_lr,
        orient_conf=opt_cfg.orient_conf_lr if opt_cfg.train_orient_conf else 0.0,
        viewspace=0.0,
    )


def cam_lrs(opt_cfg: OptimizationConfig, spatial_lr_scale: float,
            step: int) -> CameraResiduals:
    trans_lr = optim.expon_lr(step, opt_cfg.cam_translation_lr_init * spatial_lr_scale,
                              opt_cfg.cam_translation_lr_final * spatial_lr_scale,
                              max_steps=opt_cfg.cam_lr_max_steps)
    return CameraResiduals(rotation=opt_cfg.cam_rotation_lr,
                           translation=trans_lr, fov=opt_cfg.cam_fov_lr)


def compute_losses(out, gt_image, gt_mask, gt_orient_angle, gt_orient_conf,
                   opt_cfg: OptimizationConfig):
    body = gt_mask[1:]
    hair = gt_mask[:1]
    ll1 = L.l1_loss(out["render"], gt_image, mask=body)
    lssim = 1.0 - ssim(out["render"] * body, gt_image * body)
    lmask = L.l1_loss(out["mask"], gt_mask)
    lorient = L.or_loss(out["orient_angle"], gt_orient_angle,
                        confs=out["orient_conf"],
                        weight=torch.ones_like(hair) * gt_orient_conf, mask=hair)
    lorient = torch.where(torch.isnan(lorient), torch.zeros_like(lorient), lorient)
    total = (ll1 * opt_cfg.lambda_dl1 + lssim * opt_cfg.lambda_dssim
             + lmask * opt_cfg.lambda_dmask + lorient * opt_cfg.lambda_dorient)
    return total, {"l1": ll1, "ssim": lssim, "mask": lmask, "orient": lorient,
                   "total": total}


def step_grads(state: TrainState, forward):
    """Gradients of the loss ``forward(params, cam_res) -> (loss, aux)`` at
    the state's parameters and camera residuals -> (gparams, gcam, aux).
    Leaves the loss does not reach get zero gradients (all of them where it
    reaches none: a mesh rank whose window lies below the image)."""
    params = state.model.params.map(lambda t: t.detach().requires_grad_())
    cam_res = state.cam_res.map(lambda t: t.detach().requires_grad_())
    loss, aux = forward(params, cam_res)
    leaves = params.values() + cam_res.values()
    grads = (torch.autograd.grad(loss, leaves, allow_unused=True) if loss.requires_grad
             else [None] * len(leaves))
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    n_p = len(params.values())
    return gm.GaussianParams(*grads[:n_p]), CameraResiduals(*grads[n_p:]), aux


def safe_viewspace(gparams: gm.GaussianParams) -> torch.Tensor:
    """The viewspace gradient the densify statistics read: sanitized first,
    since the port is excluded from the NaN guard."""
    vs = gparams.viewspace
    return torch.where(torch.isfinite(vs), vs, torch.zeros_like(vs))


def apply_grads(state: TrainState, gparams: gm.GaussianParams,
                gcam: CameraResiduals, new_aux, drawn: torch.Tensor, *,
                opt_cfg: OptimizationConfig, trainable_cameras: bool,
                trainable_intrinsics: bool):
    """The update of one step from its gradients: the NaN-guarded Adam on
    the Gaussian parameters (train_gaussians.py:174-181; torch.where, not a
    multiplicative mask, since 0 * NaN = NaN; a skipped step leaves moments
    and count as they were), Adam on the camera rows ``drawn`` ([N] float,
    1 where drawn) and the new densify statistics ``new_aux``.  Returns
    (new_state, ok)."""
    ok = optim.grads_are_finite(
        gparams.replace(viewspace=torch.zeros_like(gparams.viewspace)))
    lrs = param_lrs(opt_cfg, state.model.spatial_lr_scale, state.step)
    updates, new_opt = optim.adam_update(gparams, state.opt, lrs)
    with torch.no_grad():
        new_params = state.model.params.map(
            lambda p, u: p + torch.where(ok, u, torch.zeros_like(u)), updates)
        new_opt = optim.where_ok(ok, new_opt, state.opt)
        if trainable_cameras or trainable_intrinsics:
            new_cam_res, new_cam_opt = _camera_adam(state, gcam, drawn, opt_cfg)
        else:
            new_cam_res, new_cam_opt = state.cam_res, state.cam_opt
    new_model = state.model.replace(params=new_params, aux=new_aux)
    return TrainState(new_model, new_opt, new_cam_res, new_cam_opt, state.step + 1), ok


def train_step(state: TrainState, cam_batch: CameraBatch, gt: GtBatch,
               cam_idx: int, *, active_sh_degree: int, width: int, height: int,
               raster_cfg: RasterConfig, opt_cfg: OptimizationConfig,
               trainable_cameras: bool, trainable_intrinsics: bool,
               use_barf: bool, white_background: bool):
    """One stage-1 step on camera ``cam_idx``.  Returns (new_state,
    metrics); metrics hold device scalars plus ``num_rendered`` and
    ``num_rendered_3sigma`` (ints: the instances binned and those that the
    reference's 3-sigma tile rect would bin)."""
    device = state.model.params.xyz.device
    bg = default_background(white_background, device)
    alive = state.model.aux.alive

    def forward(params, cam_res):
        cam = camera_geom(cam_batch.colmap_transform[cam_idx], cam_batch.fovx[cam_idx],
                          cam_batch.fovy[cam_idx], width, height, cam_res, cam_idx,
                          use_barf=use_barf, trainable_cameras=trainable_cameras,
                          trainable_intrinsics=trainable_intrinsics)
        out = render(params, alive, active_sh_degree, cam, bg, raster_cfg)
        loss, parts = compute_losses(out, gt.image[cam_idx], gt.mask[cam_idx],
                                     gt.orient_angle[cam_idx],
                                     gt.orient_conf[cam_idx], opt_cfg)
        return loss, (parts, out)

    gparams, gcam, (parts, out) = step_grads(state, forward)
    new_aux = densify.add_stats(state.model.aux, safe_viewspace(gparams), out["radii"],
                                out["visibility_filter"])
    drawn = torch.zeros(len(state.cam_opt.count), device=device)
    drawn[cam_idx] = 1.0
    new_state, ok = apply_grads(state, gparams, gcam, new_aux, drawn, opt_cfg=opt_cfg,
                                trainable_cameras=trainable_cameras,
                                trainable_intrinsics=trainable_intrinsics)
    metrics = {k: v.detach() for k, v in parts.items()}
    metrics["num_rendered"] = out["num_rendered"]
    metrics["num_rendered_3sigma"] = out["num_rendered_3sigma"]
    metrics["grads_ok"] = ok
    return new_state, metrics


def train_step_batched(state: TrainState, cam_batch: CameraBatch, gt: GtBatch,
                       cam_idxs, *, active_sh_degree: int, width: int, height: int,
                       raster_cfg: RasterConfig, opt_cfg: OptimizationConfig,
                       trainable_cameras: bool, trainable_intrinsics: bool,
                       use_barf: bool, white_background: bool):
    """One stage-1 step on the B distinct cameras ``cam_idxs``, all B
    rendered by one ``rasterize_batched`` (one launch of each compositing
    kernel), then one update: the single-process twin of the camera
    data-parallel mesh step (the JAX package's ``train_step_batched``).

    The loss is the sum over cameras; the Gaussian gradients are divided by
    B (the camera mean), the camera-residual rows keep each camera's
    gradient at full strength (``_camera_adam`` on the B drawn rows), and
    the densify statistics add up as over B single steps, camera by camera
    (``densify.add_stats``).  The viewspace port gets a row per camera, so
    each camera's gradient comes back on its own; the Adam moments of the
    (frozen) viewspace take their camera mean as the mesh step's do, where
    the JAX step gives them zero.  At B = 1 this is ``train_step`` bit for
    bit.  Returns (new_state, metrics): the loss terms averaged over
    cameras, ``num_rendered`` and ``num_rendered_3sigma`` the totals over
    them (ints)."""
    cam_idxs = [int(i) for i in cam_idxs]
    n = len(cam_idxs)
    if n < 1 or len(set(cam_idxs)) != n:
        raise ValueError(f"cam_idxs {cam_idxs}: a batch needs distinct cameras")
    device = state.model.params.xyz.device
    bg = default_background(white_background, device)
    alive = state.model.aux.alive
    params = state.model.params
    per_camera_vs = params.replace(
        viewspace=params.viewspace.expand(n, -1, -1).contiguous())
    vs_state = dataclasses.replace(state, model=state.model.replace(params=per_camera_vs))

    def forward(params, cam_res):
        cams = [camera_geom(cam_batch.colmap_transform[i], cam_batch.fovx[i],
                            cam_batch.fovy[i], width, height, cam_res, i,
                            use_barf=use_barf, trainable_cameras=trainable_cameras,
                            trainable_intrinsics=trainable_intrinsics) for i in cam_idxs]
        out = render_fields_batched(fields_from_params(params, alive), active_sh_degree,
                                    cams, bg, raster_cfg, viewspace_batch=params.viewspace)
        losses, parts = [], []
        for b, i in enumerate(cam_idxs):
            loss, p = compute_losses({k: out[k][b] for k in ("render", "mask", "orient_angle",
                                                             "orient_conf")},
                                     gt.image[i], gt.mask[i], gt.orient_angle[i],
                                     gt.orient_conf[i], opt_cfg)
            losses.append(loss)
            parts.append(p)
        return torch.stack(losses).sum(), (parts, out)

    gparams, gcam, (parts, out) = step_grads(vs_state, forward)
    g_vs = gparams.viewspace                                       # [B, P, 3]
    gparams = gparams.replace(viewspace=g_vs.sum(0)).map(lambda g: g / n)
    # the densify statistics as over B single steps, one camera after another
    safe_vs = torch.where(torch.isfinite(g_vs), g_vs, torch.zeros_like(g_vs))
    new_aux = state.model.aux
    for b in range(n):
        new_aux = densify.add_stats(new_aux, safe_vs[b], out["radii"][b],
                                    out["visibility_filter"][b])
    drawn = torch.zeros(len(state.cam_opt.count), device=device)
    drawn[cam_idxs] = 1.0
    new_state, ok = apply_grads(state, gparams, gcam, new_aux, drawn, opt_cfg=opt_cfg,
                                trainable_cameras=trainable_cameras,
                                trainable_intrinsics=trainable_intrinsics)
    metrics = {k: torch.stack([p[k] for p in parts]).detach().mean() for k in parts[0]}
    metrics["num_rendered"] = out["num_rendered"]
    metrics["num_rendered_3sigma"] = out["num_rendered_3sigma"]
    metrics["grads_ok"] = ok
    return new_state, metrics


def _camera_adam(state: TrainState, gcam: CameraResiduals, drawn: torch.Tensor,
                 opt_cfg: OptimizationConfig):
    """Adam on the drawn camera rows only (every row's moments and count
    stay as they were unless its row was drawn): one row for the
    single-camera step, the union of the data ranks' rows for the mesh step
    (the JAX package's dense-row update, data_parallel.py:107-138)."""
    do_cam = optim.grads_are_finite(gcam) & (state.step < opt_cfg.iterations_cam)
    clrs = cam_lrs(opt_cfg, state.model.spatial_lr_scale, state.step)
    sel = (drawn * do_cam.to(torch.float32))[:, None] > 0
    count = state.cam_opt.count + sel[:, 0].to(torch.int32)
    cnt = torch.clamp(count, min=1).to(torch.float32)[:, None]
    b1, b2, eps = 0.9, 0.999, 1e-15
    c1 = 1 - torch.pow(b1, cnt)
    c2 = 1 - torch.pow(b2, cnt)
    mus, nus, ress = {}, {}, {}
    for name in CameraResiduals.names():
        mu, nu = getattr(state.cam_opt.mu, name), getattr(state.cam_opt.nu, name)
        g, res = getattr(gcam, name), getattr(state.cam_res, name)
        lr = getattr(clrs, name)
        mus[name] = torch.where(sel, b1 * mu + (1 - b1) * g, mu)
        nus[name] = torch.where(sel, b2 * nu + (1 - b2) * g ** 2, nu)
        step_row = -lr * (mus[name] / c1) / (torch.sqrt(nus[name] / c2) + eps)
        ress[name] = res + torch.where(sel, step_row, torch.zeros_like(step_row))
    return (CameraResiduals(**ress),
            CamAdamState(CameraResiduals(**mus), CameraResiduals(**nus), count))


def densify_step(state: TrainState, samples: torch.Tensor, extent: float, *,
                 opt_cfg: OptimizationConfig, max_screen_size) -> TrainState:
    model, opt = densify.densify_and_prune(
        state.model, state.opt, samples, opt_cfg.densify_grad_threshold, 0.005,
        extent, max_screen_size, opt_cfg.percent_dense)
    return dataclasses.replace(state, model=model, opt=opt)


def opacity_reset_step(state: TrainState) -> TrainState:
    model, opt = densify.reset_opacity(state.model, state.opt)
    return dataclasses.replace(state, model=model, opt=opt)


def init_train_state(model_state: gm.GaussianModelState, n_cameras: int,
                     use_barf: bool) -> TrainState:
    device = model_state.params.xyz.device
    cam_res = CameraResiduals.create(n_cameras, use_barf, device)
    return TrainState(
        model=model_state,
        opt=optim.adam_init(model_state.params),
        cam_res=cam_res,
        cam_opt=CamAdamState(cam_res.map(torch.zeros_like),
                             cam_res.map(torch.zeros_like),
                             torch.zeros(n_cameras, dtype=torch.int32, device=device)),
        step=0,
    )


def train_state_from_numpy(params: dict, aux: dict, opt_mu: dict, opt_nu: dict,
                           opt_count, cam_res: dict, cam_mu: dict, cam_nu: dict,
                           cam_count, step: int, *, active_sh_degree: int,
                           max_sh_degree: int, spatial_lr_scale: float,
                           device) -> TrainState:
    """Carry a full train state across from plain dicts of numpy arrays
    (parameters, aux stats, Adam moments and count, camera residuals and
    the per-camera Adam)."""
    f = lambda x: torch.as_tensor(np.array(x, np.float32), device=device)
    i = lambda x: torch.as_tensor(np.array(x, np.int32), device=device)
    model = gm.state_from_numpy(params, aux, active_sh_degree, max_sh_degree,
                                spatial_lr_scale, device)
    rec = lambda cls, d: cls(**{n: f(d[n]) for n in cls.names()})
    return TrainState(
        model=model,
        opt=optim.AdamState(rec(gm.GaussianParams, opt_mu),
                            rec(gm.GaussianParams, opt_nu), i(opt_count)),
        cam_res=rec(CameraResiduals, cam_res),
        cam_opt=CamAdamState(rec(CameraResiduals, cam_mu),
                             rec(CameraResiduals, cam_nu), i(cam_count)),
        step=int(step))


def evaluate(state: TrainState, cams, cam_batch: CameraBatch, gt: GtBatch,
             indices, *, active_sh_degree, width, height, raster_cfg,
             model_cfg: ModelConfig, name="test", logger=None, iteration=0,
             log_gt=False) -> dict:
    """In-training eval over a camera set: mean L1 / mask L1 / orientation
    loss / PSNR (the training_report loop, train_gaussians.py:241-287).
    With ``logger``, the first <=5 views' render, mask and orientation
    images go to the image log (train_gaussians.py:264-272; the GT grids
    too when ``log_gt``).  One render (one forward-kernel launch) per view:
    the logged images come from the render that was scored."""
    device = state.model.params.xyz.device
    bg = default_background(model_cfg.white_background, device)
    totals = np.zeros(4)
    with torch.no_grad():
        for vi, i in enumerate(indices):
            cam = camera_geom(cam_batch.colmap_transform[i], cam_batch.fovx[i],
                              cam_batch.fovy[i], width, height, state.cam_res, i,
                              use_barf=model_cfg.use_barf,
                              trainable_cameras=model_cfg.trainable_cameras,
                              trainable_intrinsics=model_cfg.trainable_intrinsics)
            out = render(state.model.params, state.model.aux.alive,
                         active_sh_degree, cam, bg, raster_cfg)
            img = torch.clamp(out["render"], 0.0, 1.0)
            mask = torch.clamp(out["mask"], 0.0, 1.0)
            angle = torch.clamp(out["orient_angle"], 0.0, 1.0)
            gt_img = torch.clamp(gt.image[i], 0.0, 1.0)
            gt_mask = torch.clamp(gt.mask[i], 0.0, 1.0)
            totals += torch.stack([
                L.l1_loss(img, gt_img), L.l1_loss(mask, gt_mask),
                L.or_loss(angle, gt.orient_angle[i], mask=gt_mask[:1],
                          weight=gt.orient_conf[i]),
                L.psnr(img, gt_img)]).cpu().numpy()
            if logger is not None and vi < 5:
                img, mask, angle, oconf = (t.cpu().numpy() for t in (
                    img, mask, angle, out["orient_conf"]))
                vn = cams[i].image_name
                conf_vis = (1.0 - 1.0 / (oconf + 1.0)) * mask[:1]
                logger.images(
                    iteration,
                    **{f"{name}_view_{vn}/render": img,
                       f"{name}_view_{vn}/render_mask": mask,
                       f"{name}_view_{vn}/render_orient": vis_orient(angle, mask[:1]),
                       f"{name}_view_{vn}/render_orient_conf": vis_orient(angle, conf_vis)})
                if log_gt:
                    g_img, g_mask, g_angle, g_conf = (t[i].cpu().numpy() for t in (
                        gt.image, gt.mask, gt.orient_angle, gt.orient_conf))
                    gt_conf_vis = (1.0 - 1.0 / (g_conf + 1.0)) * g_mask[:1]
                    logger.images(
                        iteration,
                        **{f"{name}_view_{vn}/ground_truth": g_img,
                           f"{name}_view_{vn}/ground_truth_mask": g_mask,
                           f"{name}_view_{vn}/ground_truth_orient":
                               vis_orient(g_angle, g_mask[:1]),
                           f"{name}_view_{vn}/ground_truth_orient_conf":
                               vis_orient(g_angle, gt_conf_vis)})
    totals /= max(len(indices), 1)
    return {f"{name}_l1": totals[0], f"{name}_ce": totals[1],
            f"{name}_or": totals[2], f"{name}_psnr": totals[3]}


def checkpoint_arrays(state: TrainState) -> dict:
    """The state as the checkpoint's numpy arrays: model capture, optimizer
    moments, camera residuals and the step (train_gaussians.py:198-208),
    under the JAX package's key names."""
    np_ = lambda t: t.detach().cpu().numpy()
    blob = gm.capture(state.model)
    for rec, prefix in ((state.opt.mu, "opt.mu"), (state.opt.nu, "opt.nu"),
                        (state.cam_res, "cam_res"), (state.cam_opt.mu, "cam_opt.mu"),
                        (state.cam_opt.nu, "cam_opt.nu")):
        for k, v in zip(rec.names(), rec.values()):
            blob[f"{prefix}.{k}"] = np_(v)
    blob["opt.count"] = np_(state.opt.count)
    blob["cam_opt.count"] = np_(state.cam_opt.count)
    blob["step"] = np.asarray(state.step, np.int32)
    return blob


def state_digest(state: TrainState) -> str:
    """sha256 (hex) of every array of the state, by key: equal states,
    equal bits."""
    h = hashlib.sha256()
    for k, v in sorted(checkpoint_arrays(state).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def save_checkpoint(state: TrainState, path: str) -> None:
    """npz checkpoint of ``checkpoint_arrays``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **checkpoint_arrays(state))


def load_checkpoint(path: str, device=None) -> TrainState:
    """A checkpoint written by ``save_checkpoint`` of either package."""
    with np.load(path) as z:
        return state_from_arrays(dict(z), device)


def state_from_arrays(d: dict, device=None) -> TrainState:
    """A state from ``checkpoint_arrays``' dict of numpy arrays."""
    sub = lambda pre: {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}
    return train_state_from_numpy(
        sub("params."), sub("aux."), sub("opt.mu."), sub("opt.nu."), d["opt.count"],
        sub("cam_res."), sub("cam_opt.mu."), sub("cam_opt.nu."), d["cam_opt.count"],
        int(d["step"]), active_sh_degree=int(d["active_sh_degree"]),
        max_sh_degree=int(d["max_sh_degree"]),
        spatial_lr_scale=float(d["spatial_lr_scale"]), device=resolve_device(device))


def save_camera_pickles(state: TrainState, cams, cam_batch: CameraBatch,
                        model_path: str, iteration: int, use_barf: bool,
                        width: int, height: int) -> None:
    """cameras/{iter}.pkl + {iter}_matrices.pkl, the contract with FLAME
    fitting and stages 2 and 3 (train_gaussians.py:203-208).  They hold
    numpy arrays, never tensors."""
    os.makedirs(os.path.join(model_path, "cameras"), exist_ok=True)
    res = state.cam_res.map(lambda t: t.detach().cpu().numpy())
    rot = {c.image_name: np.array(res.rotation[i]) for i, c in enumerate(cams)}
    trans = {c.image_name: np.array(res.translation[i]) for i, c in enumerate(cams)}
    fov = {c.image_name: np.array(res.fov[i]) for i, c in enumerate(cams)}
    with open(os.path.join(model_path, "cameras", f"{iteration}.pkl"), "wb") as f:
        pickle.dump((rot, trans, fov), f)
    matrices = {}
    with torch.no_grad():
        for i, c in enumerate(cams):
            geom = camera_geom(cam_batch.colmap_transform[i], cam_batch.fovx[i],
                               cam_batch.fovy[i], width, height, state.cam_res, i,
                               use_barf=use_barf)
            matrices[c.image_name] = geom.projmatrix.cpu().numpy()
    with open(os.path.join(model_path, "cameras", f"{iteration}_matrices.pkl"), "wb") as f:
        pickle.dump(matrices, f)


def gui_camera(custom_cam: dict, device) -> proj.CameraGeom:
    """The camera of a viewer request (``network_gui.receive``): its
    row-vector view and projection matrices and fields of view."""
    f32 = lambda v: torch.tensor(np.array(v, np.float32), device=device)
    viewmatrix = f32(custom_cam["world_view_transform"])
    return proj.CameraGeom(
        viewmatrix=viewmatrix, projmatrix=f32(custom_cam["full_proj_transform"]),
        tan_fovx=torch.tan(f32(custom_cam["fovx"] * 0.5)),
        tan_fovy=torch.tan(f32(custom_cam["fovy"] * 0.5)),
        width=custom_cam["width"], height=custom_cam["height"],
        campos=torch.linalg.inv(viewmatrix)[3, :3])


def poll_gui(state: TrainState, model_cfg: ModelConfig, raster_cfg: RasterConfig,
             active_sh_degree: int, iteration: int, total_iters: int) -> None:
    """Live-viewer poll, one call per training iteration
    (train_gaussians.py:79-92): accept a SIBR connection if one is pending,
    answer each received camera with a view rendered on the training device
    (H x W x 3 uint8 bytes, the render clipped to [0, 1] and scaled by 255),
    and return to training when the viewer lets it go (do_training and
    (iteration < total or not keep_alive)).  Without a listener
    (``network_gui.init`` not called) it returns at once."""
    if network_gui.listener is None:
        return
    if network_gui.conn is None:
        network_gui.try_connect()
    while network_gui.conn is not None:
        try:
            net_image_bytes = None
            (custom_cam, do_training, _convert_shs, _compute_cov3d,
             keep_alive, scaling_modifier) = network_gui.receive()
            if custom_cam is not None:
                model = state.model
                device = model.params.xyz.device
                with torch.no_grad():
                    out = render(model.params, model.aux.alive, active_sh_degree,
                                 gui_camera(custom_cam, device),
                                 default_background(model_cfg.white_background, device),
                                 raster_cfg, scaling_modifier)
                    img = (out["render"][:3].clamp(0.0, 1.0) * 255).to(torch.uint8)
                net_image_bytes = img.permute(1, 2, 0).contiguous().cpu().numpy().tobytes()
            network_gui.send(net_image_bytes, model_cfg.source_path)
            if do_training and (iteration < total_iters or not keep_alive):
                break
        except Exception:
            network_gui.conn = None


def train(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
          pipe_cfg: PipelineConfig, scene, *,
          test_iterations=(1000, 5000, 15000, 30000),
          save_iterations=(1000, 5000, 15000, 30000),
          checkpoint_iterations=(30000,), start_checkpoint=None,
          progress_callback=None, mesh_spec: str = "", camera_batch: int = 1,
          device=None, seed: int = 0) -> TrainState:
    """Host-side training loop (train_gaussians.py:78-208).

    ``scene`` holds ``train_cameras`` (scene.cameras.CameraStatic with
    ground truth), ``points``, ``colors`` and ``cameras_extent``, and may
    hold ``test_cameras``.  Runs on CUDA unless ``device="cpu"`` is passed.
    Camera draws follow the JAX package (``random.Random(0)`` epochs); the
    split samples of densification come from a ``torch.Generator`` seeded
    with ``seed``.

    With ``model_cfg.model_path`` set, every 10 iterations the losses,
    ``num_rendered``, ``num_alive`` and a loss EMA go to ``metrics.jsonl``;
    at ``test_iterations`` the evaluation report and the opacity / label
    histograms too; ``save_iterations`` write ``point_cloud/iteration_<i>/
    (raw_)point_cloud.ply`` and ``checkpoint_iterations`` write
    ``checkpoints/<i>.npz`` and the camera pickles.  The JAX package also
    logs ``instance_occupancy`` against its static instance buffer; the
    port's binning sizes that buffer from ``num_rendered`` on every call, so
    there is no occupancy to log.  ``start_checkpoint`` resumes from a
    checkpoint of either package, with its slot capacity.

    ``camera_batch`` B > 1 runs ``train_step_batched`` on B distinct
    cameras per iteration (drawn as the JAX package draws them: from the
    epoch stack, a camera already in the batch put back into the stack),
    the camera-mean gradient of one process and one launch of each kernel;
    it logs ``num_rendered`` totalled over the batch.  It excludes
    ``mesh_spec``.

    ``mesh_spec`` "DATAxTILE" (e.g. "4x2") runs the multi-device step of
    ``parallel/tile_parallel`` on a (camera, tile-row) process mesh, one
    process per rank (``parallel/mesh.py``); each iteration then takes DATA
    cameras (gradients averaged: a batch-size departure from the
    reference's one camera per iteration, as in the JAX package).  Every
    rank draws the same cameras and data rank d takes the d-th; densify and
    opacity resets run on every rank on the replicated state.  Rank 0 alone
    logs, evaluates, writes files and serves the viewer; while the viewer
    holds rank 0, the other ranks wait in the step's first collective.  At
    the end the ranks
    compare state hashes (a difference raises) and rank 0 prints a
    ``mesh_summary`` JSON line: per rank the step ms, the ms and bytes of
    its collectives per step and its kernel launches."""
    if camera_batch < 1:
        raise ValueError(f"camera_batch {camera_batch} < 1")
    if camera_batch > 1 and mesh_spec:
        raise ValueError("camera_batch and mesh_spec are mutually exclusive")
    mesh = None
    if mesh_spec:
        from gaussianhaircut_torch.parallel.mesh import make_mesh2d, parse_mesh_spec
        from gaussianhaircut_torch.parallel.tile_parallel import dp_tp_train_step
        mesh = make_mesh2d(*parse_mesh_spec(mesh_spec), device)
        device = mesh.device
    else:
        device = resolve_device(device)
    main_rank = mesh is None or mesh.rank == 0
    n_data = mesh.n_data if mesh else camera_batch
    cams = scene.train_cameras
    if not cams:
        raise ValueError("no training cameras")
    if camera_batch > len(cams):
        raise ValueError(f"camera_batch {camera_batch} > {len(cams)} cameras")
    width, height = cams[0].width, cams[0].height
    cam_batch = CameraBatch.from_cameras(cams, device)
    gt = GtBatch.from_cameras(cams, device)

    if start_checkpoint:
        state = load_checkpoint(start_checkpoint, device)
    else:
        capacity = pipe_cfg.gaussian_capacity or max(
            1 << (len(scene.points) * 4 - 1).bit_length(), 1 << 17)
        model_state = gm.create_from_pcd(scene.points, scene.colors, capacity,
                                         model_cfg.sh_degree, scene.cameras_extent,
                                         device)
        state = init_train_state(model_state, len(cams), model_cfg.use_barf)
    capacity = state.model.capacity
    raster_cfg = RasterConfig(tile_w=pipe_cfg.tile, tile_h=pipe_cfg.tile)
    logger = (MetricsLogger(model_cfg.model_path)
              if model_cfg.model_path and main_rank else None)
    test_cams = getattr(scene, "test_cameras", None) or []
    rng = random.Random(0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stack: list[int] = []
    ema = 0.0
    warned_slots = False
    first_step, launches0 = state.step, dict(kernels.launches)
    t_loop = time.perf_counter()
    for iteration in range(state.step + 1, opt_cfg.iterations + 1):
        sh_deg = min(iteration // 1000, model_cfg.sh_degree)
        if main_rank:
            poll_gui(state, model_cfg, raster_cfg, sh_deg, iteration, opt_cfg.iterations)
        if len(stack) < n_data:
            # a fresh shuffled epoch in front of the leftovers, so that no
            # camera of an epoch is dropped when n_data does not divide it
            new_epoch = list(range(len(cams)))
            rng.shuffle(new_epoch)
            stack = new_epoch + stack
        if camera_batch > 1:
            # distinct within the batch: a camera drawn twice (the stack can
            # hold the end of one epoch and a whole next one) is put back
            idxs = []
            while len(idxs) < camera_batch:
                i = stack.pop(rng.randrange(len(stack)))
                if i in idxs:
                    stack.insert(0, i)
                else:
                    idxs.append(i)
        else:
            idxs = [stack.pop(rng.randrange(len(stack))) for _ in range(n_data)]
        step_kw = dict(active_sh_degree=sh_deg, width=width, height=height,
                       raster_cfg=raster_cfg, opt_cfg=opt_cfg,
                       trainable_cameras=model_cfg.trainable_cameras,
                       trainable_intrinsics=model_cfg.trainable_intrinsics,
                       use_barf=model_cfg.use_barf,
                       white_background=model_cfg.white_background)
        if camera_batch > 1:
            state, metrics = train_step_batched(state, cam_batch, gt, idxs, **step_kw)
        elif mesh is None:
            state, metrics = train_step(state, cam_batch, gt, idxs[0], **step_kw)
        else:
            state, metrics = dp_tp_train_step(mesh, **step_kw)(state, cam_batch, gt, idxs)

        if iteration < opt_cfg.densify_until_iter:
            if (iteration > opt_cfg.densify_from_iter
                    and iteration % opt_cfg.densification_interval == 0):
                size_thr = 20 if iteration > opt_cfg.opacity_reset_interval else None
                samples = torch.randn((2, capacity, 3), generator=gen, device=device)
                state = densify_step(state, samples, scene.cameras_extent,
                                     opt_cfg=opt_cfg, max_screen_size=size_thr)
                n_alive = state.model.num_alive()
                if n_alive >= 0.99 * capacity and not warned_slots and main_rank:
                    warned_slots = True
                    print(f"\n[iter {iteration}] gaussian slots ~exhausted "
                          f"({n_alive}/{capacity}): raise gaussian_capacity "
                          "if quality plateaus")
            if iteration % opt_cfg.opacity_reset_interval == 0 or (
                    model_cfg.white_background
                    and iteration == opt_cfg.densify_from_iter):
                state = opacity_reset_step(state)

        if logger and iteration % 10 == 0:
            m = {k: float(v) for k, v in metrics.items()}
            ema = 0.4 * m["total"] + 0.6 * ema
            logger.scalars(iteration, ema=ema,
                           num_alive=float(state.model.num_alive()), **m)
        if progress_callback:
            progress_callback(iteration, state, metrics)

        if iteration in test_iterations and main_rank:
            # training_report (train_gaussians.py:241-293): the test split
            # and a fixed sample of train views, image grids of the first
            # <=5 views, opacity / label histograms, total_points
            first_test = iteration == min(test_iterations)
            ev = dict(active_sh_degree=sh_deg, raster_cfg=raster_cfg,
                      model_cfg=model_cfg, logger=logger, iteration=iteration,
                      log_gt=first_test)
            report = {}
            if test_cams and test_cams[0].image is not None:
                report.update(evaluate(
                    state, test_cams, CameraBatch.from_cameras(test_cams, device),
                    GtBatch.from_cameras(test_cams, device), range(len(test_cams)),
                    width=test_cams[0].width, height=test_cams[0].height,
                    name="test", **ev))
            train_sample = [i % len(cams) for i in range(5, 30, 5)]
            report.update(evaluate(state, cams, cam_batch, gt, train_sample,
                                   width=width, height=height, name="train", **ev))
            msg = "  ".join(f"{k} {v:.5f}" for k, v in report.items())
            print(f"\n[ITER {iteration}] Evaluating: {msg}")
            if logger:
                logger.scalars(iteration, **report,
                               total_points=float(state.model.num_alive()))
                alive = state.model.aux.alive
                for name, fn in (("opacity", gm.get_opacity), ("label", gm.get_label)):
                    logger.histogram(iteration, f"scene/{name}_histogram",
                                     fn(state.model.params)[alive].detach().cpu().numpy())

        if iteration in save_iterations and model_cfg.model_path and main_rank:
            gm.save_ply(state.model, os.path.join(
                model_cfg.model_path, f"point_cloud/iteration_{iteration}",
                "point_cloud.ply"))
        if iteration in checkpoint_iterations and model_cfg.model_path and main_rank:
            save_checkpoint(state, os.path.join(
                model_cfg.model_path, "checkpoints", f"{iteration}.npz"))
            save_camera_pickles(state, cams, cam_batch, model_cfg.model_path,
                                iteration, model_cfg.use_barf, width, height)

    if logger:
        logger.close()
    if mesh is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        _mesh_summary(mesh, state, state.step - first_step, time.perf_counter() - t_loop,
                      launches0)
    return state


def _mesh_summary(mesh, state: TrainState, steps: int, seconds: float,
                  launches0: dict) -> None:
    """Every rank's state hash, step time, collectives and launches,
    gathered over the world: diverged ranks raise; rank 0 prints them."""
    from gaussianhaircut_torch.parallel import collectives as coll
    digest = np.frombuffer(bytes.fromhex(state_digest(state)), np.uint32)
    steps = max(steps, 1)
    fwd, bwd = (kernels.launches[k] - launches0[k] for k in ("raster_fwd", "raster_bwd"))
    rec = torch.tensor([seconds * 1e3 / steps, mesh.stats.seconds() * 1e3 / steps,
                        mesh.stats.bytes / steps, fwd, bwd, *digest.astype(np.float64)],
                       dtype=torch.float64, device=mesh.device)
    recs = coll.all_gather(mesh, rec, "world").cpu().numpy()
    digests = {np.asarray(r[5:], np.uint32).tobytes().hex() for r in recs}
    if len(digests) != 1:
        raise RuntimeError(f"mesh ranks diverged: {len(digests)} different states")
    if mesh.rank == 0:
        print("mesh_summary " + json.dumps({
            "mesh": f"{mesh.n_data}x{mesh.n_tile}", "backend": mesh.backend,
            "device": str(mesh.device), "steps": steps, "state_sha256": digests.pop(),
            "ranks": [{"rank": i, "step_ms": float(r[0]), "collective_ms_per_step": float(r[1]),
                       "bytes_per_step": float(r[2]),
                       "launches": {"raster_fwd": int(r[3]), "raster_bwd": int(r[4])}}
                      for i, r in enumerate(recs)]}), flush=True)
