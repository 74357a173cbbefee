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

This slice ports the single-camera step and the loop around it.  The CLI,
evaluation, PLY/checkpoint saving and camera pickles come with the next
slice; the batched-camera and mesh steps are not ported.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.ops import losses as L
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.ops.ssim import ssim
from gaussianhaircut_torch.render.renderer import default_background, render
from gaussianhaircut_torch.scene.cameras import CameraBatch, CameraResiduals, camera_geom
from gaussianhaircut_torch.train import densify, optim

_LATER_SLICE = ("comes with the next slice of the port (the stage-1 CLI, "
                "evaluation, PLY/checkpoint saving and camera pickles)")


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


def train_step(state: TrainState, cam_batch: CameraBatch, gt: GtBatch,
               cam_idx: int, *, active_sh_degree: int, width: int, height: int,
               raster_cfg: RasterConfig, opt_cfg: OptimizationConfig,
               trainable_cameras: bool, trainable_intrinsics: bool,
               use_barf: bool, white_background: bool):
    """One stage-1 step on camera ``cam_idx``.  Returns (new_state,
    metrics); metrics hold device scalars plus ``num_rendered`` (an int)."""
    device = state.model.params.xyz.device
    bg = default_background(white_background, device)
    alive = state.model.aux.alive
    params = state.model.params.map(lambda t: t.detach().requires_grad_())
    cam_res = state.cam_res.map(lambda t: t.detach().requires_grad_())

    cam = camera_geom(cam_batch.colmap_transform[cam_idx], cam_batch.fovx[cam_idx],
                      cam_batch.fovy[cam_idx], width, height, cam_res, cam_idx,
                      use_barf=use_barf, trainable_cameras=trainable_cameras,
                      trainable_intrinsics=trainable_intrinsics)
    out = render(params, alive, active_sh_degree, cam, bg, raster_cfg)
    loss, parts = compute_losses(out, gt.image[cam_idx], gt.mask[cam_idx],
                                 gt.orient_angle[cam_idx],
                                 gt.orient_conf[cam_idx], opt_cfg)
    leaves = params.values() + cam_res.values()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    n_p = len(params.values())
    gparams = gm.GaussianParams(*grads[:n_p])
    gcam = CameraResiduals(*grads[n_p:])

    # densify stats read the viewspace port; sanitized first (the port is
    # excluded from the NaN guard)
    vs = gparams.viewspace
    safe_vs = torch.where(torch.isfinite(vs), vs, torch.zeros_like(vs))
    new_aux = densify.add_stats(state.model.aux, safe_vs, out["radii"],
                                out["visibility_filter"])

    # Gaussian Adam step with the NaN guard (train_gaussians.py:174-181):
    # torch.where, not a multiplicative mask (0 * NaN = NaN); a skipped step
    # leaves moments and count as they were
    ok = optim.grads_are_finite(gparams.replace(viewspace=torch.zeros_like(vs)))
    lrs = param_lrs(opt_cfg, state.model.spatial_lr_scale, state.step)
    updates, new_opt = optim.adam_update(gparams, state.opt, lrs)
    with torch.no_grad():
        new_params = state.model.params.map(
            lambda p, u: p + torch.where(ok, u, torch.zeros_like(u)), updates)
        new_opt = optim.AdamState(new_opt.mu.map(_where_ok(ok), state.opt.mu),
                                  new_opt.nu.map(_where_ok(ok), state.opt.nu),
                                  torch.where(ok, new_opt.count, state.opt.count))
        if trainable_cameras or trainable_intrinsics:
            new_cam_res, new_cam_opt = _camera_adam(state, gcam, cam_idx, opt_cfg)
        else:
            new_cam_res, new_cam_opt = state.cam_res, state.cam_opt

    new_model = state.model.replace(params=new_params, aux=new_aux)
    new_state = TrainState(new_model, new_opt, new_cam_res, new_cam_opt,
                           state.step + 1)
    metrics = {k: v.detach() for k, v in parts.items()}
    metrics["num_rendered"] = out["num_rendered"]
    metrics["grads_ok"] = ok
    return new_state, metrics


def _where_ok(ok):
    return lambda new, old: torch.where(ok, new, old)


def _camera_adam(state: TrainState, gcam: CameraResiduals, cam_idx: int,
                 opt_cfg: OptimizationConfig):
    """Adam on the drawn camera's residual row only."""
    do_cam = optim.grads_are_finite(gcam) & (state.step < opt_cfg.iterations_cam)
    clrs = cam_lrs(opt_cfg, state.model.spatial_lr_scale, state.step)
    row_count = (state.cam_opt.count[cam_idx] + 1).to(torch.float32)
    b1, b2, eps = 0.9, 0.999, 1e-15
    c1 = 1 - torch.pow(b1, row_count)
    c2 = 1 - torch.pow(b2, row_count)
    mus, nus, ress = {}, {}, {}
    for name in CameraResiduals.names():
        mu, nu = getattr(state.cam_opt.mu, name), getattr(state.cam_opt.nu, name)
        g, res = getattr(gcam, name), getattr(state.cam_res, name)
        lr = getattr(clrs, name)
        mu_row = b1 * mu[cam_idx] + (1 - b1) * g[cam_idx]
        nu_row = b2 * nu[cam_idx] + (1 - b2) * g[cam_idx] ** 2
        step_row = -lr * (mu_row / c1) / (torch.sqrt(nu_row / c2) + eps)
        mus[name], nus[name], ress[name] = mu.clone(), nu.clone(), res.clone()
        mus[name][cam_idx] = torch.where(do_cam, mu_row, mu[cam_idx])
        nus[name][cam_idx] = torch.where(do_cam, nu_row, nu[cam_idx])
        ress[name][cam_idx] = res[cam_idx] + torch.where(
            do_cam, step_row, torch.zeros_like(step_row))
    count = state.cam_opt.count.clone()
    count[cam_idx] += do_cam.to(torch.int32)
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


def train(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
          pipe_cfg: PipelineConfig, scene, *, test_iterations=(),
          save_iterations=(), checkpoint_iterations=(), start_checkpoint=None,
          progress_callback=None, mesh_spec: str = "", camera_batch: int = 1,
          device=None, seed: int = 0) -> TrainState:
    """Host-side training loop (train_gaussians.py:78-208).

    ``scene`` holds ``train_cameras`` (scene.cameras.CameraStatic with
    ground truth), ``points``, ``colors`` and ``cameras_extent``.  Runs on
    CUDA unless ``device="cpu"`` is passed.  Camera draws follow the JAX
    package (``random.Random(0)`` epochs); the split samples of densification
    come from a ``torch.Generator`` seeded with ``seed``."""
    if test_iterations or save_iterations or checkpoint_iterations \
            or start_checkpoint or model_cfg.model_path:
        raise NotImplementedError("evaluation, saving and logging " + _LATER_SLICE)
    if mesh_spec or camera_batch != 1:
        raise NotImplementedError("only the single-camera step is ported; "
                                  "mesh and batched-camera steps are not")
    device = resolve_device(device)
    cams = scene.train_cameras
    if not cams:
        raise ValueError("no training cameras")
    width, height = cams[0].width, cams[0].height
    cam_batch = CameraBatch.from_cameras(cams, device)
    gt = GtBatch.from_cameras(cams, device)

    capacity = pipe_cfg.gaussian_capacity or max(
        1 << (len(scene.points) * 4 - 1).bit_length(), 1 << 17)
    model_state = gm.create_from_pcd(scene.points, scene.colors, capacity,
                                     model_cfg.sh_degree, scene.cameras_extent,
                                     device)
    state = init_train_state(model_state, len(cams), model_cfg.use_barf)
    raster_cfg = RasterConfig(tile_w=pipe_cfg.tile, tile_h=pipe_cfg.tile)
    rng = random.Random(0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stack: list[int] = []
    warned_slots = False
    for iteration in range(state.step + 1, opt_cfg.iterations + 1):
        sh_deg = min(iteration // 1000, model_cfg.sh_degree)
        if not stack:
            stack = list(range(len(cams)))
            rng.shuffle(stack)
        cam_idx = stack.pop(rng.randrange(len(stack)))
        state, metrics = train_step(
            state, cam_batch, gt, cam_idx, active_sh_degree=sh_deg,
            width=width, height=height, raster_cfg=raster_cfg, opt_cfg=opt_cfg,
            trainable_cameras=model_cfg.trainable_cameras,
            trainable_intrinsics=model_cfg.trainable_intrinsics,
            use_barf=model_cfg.use_barf,
            white_background=model_cfg.white_background)

        if iteration < opt_cfg.densify_until_iter:
            if (iteration > opt_cfg.densify_from_iter
                    and iteration % opt_cfg.densification_interval == 0):
                size_thr = 20 if iteration > opt_cfg.opacity_reset_interval else None
                samples = torch.randn((2, capacity, 3), generator=gen, device=device)
                state = densify_step(state, samples, scene.cameras_extent,
                                     opt_cfg=opt_cfg, max_screen_size=size_thr)
                n_alive = state.model.num_alive()
                if n_alive >= 0.99 * capacity and not warned_slots:
                    warned_slots = True
                    print(f"\n[iter {iteration}] gaussian slots ~exhausted "
                          f"({n_alive}/{capacity}): raise gaussian_capacity "
                          "if quality plateaus")
            if iteration % opt_cfg.opacity_reset_interval == 0 or (
                    model_cfg.white_background
                    and iteration == opt_cfg.densify_from_iter):
                state = opacity_reset_step(state)
        if progress_callback:
            progress_callback(iteration, state, metrics)
    return state
