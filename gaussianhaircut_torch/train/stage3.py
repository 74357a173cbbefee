"""Stage-3 trainer: direct strand-polyline refinement (port of
``gaussianhaircut_tpu/train/stage3.py``; reference src/train_strands.py:
41-180, src/scene/gaussian_model_strands.py).

Learnables: per-strand segment vectors ``dirs`` [N, L-1, 3] (positions by
cumsum from the frozen stage-2 roots, gaussian_model_strands.py:435-454),
per-strand SH features and a log orientation confidence, by Adam with the
exponential xyz schedule (:578-594).  The loss adds SSIM and, with a prior,
the SDS regularizer to the stage-2 stack (train_strands.py:128-147); the SDS
gradient is taken on its own and capped relative to the image gradient.

The step's SDS draws (guiding strands, noise, sigma) come from a
``torch.Generator``, or are given as ``Stage3Draws`` (the parity tests pass
the JAX package's).  As in stage 2, no static instance buffer: the binning
sizes its buffer on every call and ``num_rendered`` is in the metrics.
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import NamedTuple

import numpy as np
import torch

from gaussianhaircut_torch.config import OptimizationConfig
from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models.diffusion import sample_density, sds_latent_image
from gaussianhaircut_torch.models.strand_prior import GEOMETRY_DIM, points_from_segments
from gaussianhaircut_torch.models.strands import per_segment, strands_to_gaussians
from gaussianhaircut_torch.models.textured_strands import (
    ScalpPool, StrandParams, TexturedStrandsConfig, generate_strands, sample_roots,
)
from gaussianhaircut_torch.ops import losses as L
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.ops.ssim import ssim
from gaussianhaircut_torch.records import TensorRecord
from gaussianhaircut_torch.render.renderer import (
    GaussianFields, default_background, render_fields,
)
from gaussianhaircut_torch.scene.cameras import CameraBatch, camera_geom
from gaussianhaircut_torch.train import optim
from gaussianhaircut_torch.train.stage2 import concat_fields, diffusion_config


@dataclasses.dataclass
class CurvesParams(TensorRecord):
    """Learnable stage-3 parameters (gaussian_model_strands.py:571-574)."""
    dirs: torch.Tensor           # [N, L-1, 3]
    features_dc: torch.Tensor    # [N, 1, 3]
    features_rest: torch.Tensor  # [N, K-1, 3]
    orient_conf: torch.Tensor    # [N, 1] (log)


@dataclasses.dataclass
class CurvesStatic(TensorRecord):
    """Frozen per-strand data from the stage-2 generator
    (gaussian_model_strands.py:521-576)."""
    origins: torch.Tensor        # [N, 1, 3]
    uvs: torch.Tensor            # [N, 2]
    local2world: torch.Tensor    # [N, 3, 3]
    z_geom: torch.Tensor         # [N, 64]


@dataclasses.dataclass
class CurvesTrainState:
    params: CurvesParams
    static: CurvesStatic
    opt: optim.AdamState
    step: int


class Stage3Draws(NamedTuple):
    """One step's SDS draws."""
    guides: torch.Tensor         # [G] int64 guiding-strand indices (with repeats)
    noise: torch.Tensor          # [1, D, D, 64]
    sigma: torch.Tensor          # [1]


@torch.no_grad()
def create_from_stage2(hair: StrandParams, pool: ScalpPool,
                       scfg: TexturedStrandsConfig,
                       roots: torch.Tensor) -> tuple[CurvesParams, CurvesStatic]:
    """Run the stage-2 generator once at the pool entries ``roots`` and
    freeze the roots and latents (gaussian_model_strands.py:521-576)."""
    strands = generate_strands(hair, pool, scfg, roots)
    dirs = strands.points[:, 1:] - strands.points[:, :-1]
    n = dirs.shape[0]
    k = (scfg.sh_degree + 1) ** 2
    out = hair.color_decoder(strands.z_app)
    params = CurvesParams(dirs=dirs, features_dc=out[:, :3].reshape(n, 1, 3),
                          features_rest=out[:, 3:3 * k].reshape(n, k - 1, 3),
                          orient_conf=out[:, 3 * k:].reshape(n, 1))
    static = CurvesStatic(strands.points[:, :1], strands.uvs, strands.local2world,
                          strands.z_geom)
    return params.map(lambda t: t.contiguous()), static.map(lambda t: t.contiguous())


def curves_points(params: CurvesParams, static: CurvesStatic) -> torch.Tensor:
    return points_from_segments(static.origins, params.dirs)


def curves_fields(params: CurvesParams, static: CurvesStatic,
                  scfg: TexturedStrandsConfig, radius_scale) -> GaussianFields:
    pts = curves_points(params, static)
    sg = strands_to_gaussians(pts, radius_scale)
    n, s = pts.shape[0], pts.shape[1] - 1
    features = torch.cat([per_segment(params.features_dc, s),
                          per_segment(params.features_rest, s)], dim=1)
    # clamped exp, as gaussian_model.get_orient_conf
    oconf = torch.exp(torch.clamp(per_segment(params.orient_conf, s), -30.0, 30.0))
    dev = pts.device
    ones = torch.ones((n * s, 1), device=dev)
    return GaussianFields(
        xyz=sg.xyz, features=features, scaling=sg.scaling,
        rotation_matrix=sg.rotation_matrix, opacity=ones, label=ones,
        orient_conf=oconf, valid=torch.ones(n * s, dtype=torch.bool, device=dev),
        viewspace=torch.zeros((n * s, 3), device=dev),
        use_direction=torch.ones(n * s, device=dev))


def draw_stage3(params: CurvesParams, scfg: TexturedStrandsConfig,
                generator: torch.Generator, num_guiding: int = 1000) -> Stage3Draws:
    """Guiding strands (with repeats, as ``jax.random.randint``), noise and
    sigma from ``generator``."""
    n = params.dirs.shape[0]
    guides = torch.randint(0, n, (min(num_guiding, n),), generator=generator,
                           device=generator.device).to(params.dirs.device)
    d = scfg.diffusion_input
    noise = torch.randn((1, d, d, GEOMETRY_DIM), generator=generator, device=generator.device)
    sigma = sample_density(diffusion_config(scfg), (1,), generator)
    return Stage3Draws(guides, noise, sigma)


def sds_loss(params: CurvesParams, static: CurvesStatic, prior: dict,
             scfg: TexturedStrandsConfig, draws: Stage3Draws) -> torch.Tensor:
    """HAAR-style SDS regularizer (gaussian_model_strands.py:456-515): the
    frozen encoder's codes of the guiding strands, resampled onto the
    diffusion grid (``sds_latent_image``), under the frozen denoiser's loss.
    prior: {"encoder": StrandEncoder, "denoiser": Denoiser}."""
    idx = draws.guides
    pts = curves_points(params, static)[idx]
    inv_l2w = torch.linalg.inv(static.local2world[idx])
    p_local = torch.einsum("nij,nlj->nli", inv_l2w, pts - static.origins[idx])
    v_local = (p_local[:, 1:] - p_local[:, :-1]) * scfg.scale_decoder
    z_gdn = prior["encoder"](p_local * scfg.scale_decoder)[:, :GEOMETRY_DIM]
    uvs = 2.0 * static.uvs[idx] - 1.0
    latent = sds_latent_image(z_gdn, uvs, v_local, scfg.diffusion_input)[None]
    return prior["denoiser"].loss(latent, draws.noise, draws.sigma)


def stage3_losses(out, gt_image, gt_mask, gt_orient_angle, gt_orient_conf,
                  l_sds, opt_cfg: OptimizationConfig):
    """train_strands.py:128-147."""
    ll1 = L.l1_loss(out["render"], gt_image)
    lssim = 1.0 - ssim(out["render"], gt_image)
    lmask = L.l1_loss(out["mask"], gt_mask)
    orient_weight = torch.ones_like(gt_mask[:1])
    if opt_cfg.use_gt_orient_conf:
        orient_weight = orient_weight * gt_orient_conf
    confs = out["orient_conf"] if opt_cfg.train_orient_conf else None
    lor = L.or_loss(out["orient_angle"], gt_orient_angle, confs=confs,
                    weight=orient_weight, mask=gt_mask[:1])
    lor = torch.where(torch.isnan(lor), torch.zeros_like(lor), lor)
    total = (ll1 * opt_cfg.lambda_dl1 + lssim * opt_cfg.lambda_dssim
             + lmask * opt_cfg.lambda_dmask + lor * opt_cfg.lambda_dorient
             + l_sds * opt_cfg.lambda_dsds)
    return total, {"l1": ll1, "ssim": lssim, "mask": lmask, "orient": lor,
                   "sds": l_sds, "total": total}


def stable_spatial_lr_scale(opt_cfg: OptimizationConfig, seg_len: float,
                            cameras_extent: float = 1.0,
                            max_lr_per_segment: float = 0.012) -> float:
    """Stage 3's stability bound: cumsum dirs move a strand's tip by up to
    (L-1) x lr per Adam step, so the dirs lr is held at
    ``max_lr_per_segment`` x the mean segment length.  Returns min(camera
    extent, that scale).  Kept as the JAX package has it, including its
    division by ``position_lr_init``, which is then multiplied back in by
    ``param_lrs`` (a known fault of the reference, kept for parity)."""
    if seg_len <= 0:
        return float(cameras_extent)
    stable = max_lr_per_segment * seg_len / opt_cfg.position_lr_init
    return float(min(cameras_extent, stable))


def param_lrs(opt_cfg: OptimizationConfig, spatial_lr_scale: float, step: int) -> CurvesParams:
    """gaussian_model_strands.py:578-594 (dirs follow the xyz schedule)."""
    xyz_lr = optim.expon_lr(step, opt_cfg.position_lr_init * spatial_lr_scale,
                            opt_cfg.position_lr_final * spatial_lr_scale,
                            lr_delay_mult=opt_cfg.position_lr_delay_mult,
                            max_steps=opt_cfg.position_lr_max_steps)
    return CurvesParams(dirs=xyz_lr, features_dc=opt_cfg.feature_lr,
                        features_rest=opt_cfg.feature_lr / 20.0,
                        orient_conf=opt_cfg.orient_conf_lr)


def train_step(state: CurvesTrainState, head: GaussianFields, cam_batch: CameraBatch,
               gt_image, gt_mask, gt_orient_angle, gt_orient_conf, cam_idx: int,
               cam_residuals, radius_scale, prior: dict | None = None,
               draws: Stage3Draws | None = None, *, scfg: TexturedStrandsConfig,
               width: int, height: int, raster_cfg: RasterConfig,
               opt_cfg: OptimizationConfig, white_background: bool,
               spatial_lr_scale: float = 1.0, use_sds: bool = False):
    """One stage-3 step.  With ``use_sds``, ``draws`` holds the SDS draws.
    Returns (new_state, metrics)."""
    bg = default_background(white_background, state.params.dirs.device)
    cam = camera_geom(cam_batch.colmap_transform[cam_idx], cam_batch.fovx[cam_idx],
                      cam_batch.fovy[cam_idx], width, height, cam_residuals, cam_idx)
    params = state.params.map(lambda t: t.detach().requires_grad_())
    leaves = params.values()
    hair = curves_fields(params, state.static, scfg, radius_scale)
    out = render_fields(concat_fields(head, hair), scfg.sh_degree, cam, bg, raster_cfg)
    img_total, parts = stage3_losses(out, gt_image, gt_mask, gt_orient_angle, gt_orient_conf,
                                     torch.zeros((), device=bg.device), opt_cfg)
    grads = CurvesParams(*torch.autograd.grad(img_total, leaves))
    if use_sds:
        # the SDS term never touches the render: its own (small) backward,
        # capped at sds_grad_ratio x the image gradient's norm
        l_sds = sds_loss(params, state.static, prior, scfg, draws)
        g_sds = torch.autograd.grad(l_sds, leaves, allow_unused=True)
        g_sds = CurvesParams(*(torch.zeros_like(p) if g is None else g * opt_cfg.lambda_dsds
                               for p, g in zip(leaves, g_sds)))
        if opt_cfg.sds_grad_ratio > 0:
            g_sds, parts["sds_gscale"] = optim.cap_norm_relative(
                g_sds, grads, opt_cfg.sds_grad_ratio)
        grads = grads.map(torch.add, g_sds)
        parts["sds"] = l_sds
        parts["total"] = img_total + opt_cfg.lambda_dsds * l_sds
    ok = optim.grads_are_finite(grads)
    if opt_cfg.hair_grad_clip > 0:
        grads, parts["grad_norm"] = optim.clip_by_global_norm(grads, opt_cfg.hair_grad_clip)
    lrs = param_lrs(opt_cfg, spatial_lr_scale, state.step)
    with torch.no_grad():
        updates, new_opt = optim.adam_update(grads, state.opt, lrs)
        # torch.where, not a multiplicative mask (0 * NaN = NaN)
        new_params = state.params.map(
            lambda p, u: p + torch.where(ok, u, torch.zeros_like(u)), updates)
        new_opt = optim.where_ok(ok, new_opt, state.opt)
    metrics = {k: v.detach() for k, v in parts.items()}
    metrics["grads_finite"] = ok.to(torch.float32)
    metrics["num_rendered"] = out["num_rendered"]
    return CurvesTrainState(new_params, state.static, new_opt, state.step + 1), metrics


def train(model_cfg, opt_cfg: OptimizationConfig, scfg: TexturedStrandsConfig,
          pipe_cfg, scene, head_model, hair_params: StrandParams, pool: ScalpPool,
          scene_scale, num_strands: int, cam_residuals=None, *,
          model_path_curves: str = "", checkpoint_iterations=(10000,),
          start_checkpoint=None, spatial_lr_scale="auto", prior: dict | None = None,
          use_sds: bool = False, sds_seed: int = 0, progress_callback=None,
          device=None) -> CurvesTrainState:
    """The host loop (train_strands.py:87-180); runs on CUDA unless
    ``device="cpu"`` is passed.  The strands are picked from the pool by a
    generator seeded with 1, the SDS draws by one seeded with ``sds_seed``.

    prior: {"encoder", "denoiser"} modules for the SDS regularizer
    (gaussian_model_strands.py:456-515), applied at ``lambda_dsds`` with
    ``use_sds``.  ``spatial_lr_scale="auto"`` applies
    ``stable_spatial_lr_scale``; a number keeps the reference's semantics."""
    from gaussianhaircut_torch.train.stage1 import GtBatch
    from gaussianhaircut_torch.train.stage2 import make_head_fields
    from gaussianhaircut_torch.utils.logger import MetricsLogger

    device = resolve_device(device)
    if use_sds and prior is None:
        raise ValueError("use_sds requires a prior ({'encoder', 'denoiser'})")
    if prior is not None:
        prior = {k: m.to(device).requires_grad_(False) for k, m in prior.items()}
    cams = scene.train_cameras
    width, height = cams[0].width, cams[0].height
    cam_batch = CameraBatch.from_cameras(cams, device)
    gt = GtBatch.from_cameras(cams, device)
    head = make_head_fields(head_model)

    if start_checkpoint:
        state = load_checkpoint(start_checkpoint, device)
    else:
        roots = sample_roots(pool, num_strands, torch.Generator().manual_seed(1))
        params, static = create_from_stage2(hair_params, pool.to(device), scfg,
                                            roots.to(device))
        state = CurvesTrainState(params, static, optim.adam_init(params), 0)

    raster_cfg = RasterConfig(tile_w=pipe_cfg.tile, tile_h=pipe_cfg.tile)
    radius_scale = torch.tensor(model_cfg.strand_scale * float(scene_scale),
                                dtype=torch.float32, device=device)
    seg_len = float(torch.linalg.norm(state.params.dirs, dim=-1).mean())
    if spatial_lr_scale == "auto":
        extent = float(getattr(scene, "cameras_extent", 1.0) or 1.0)
        spatial_lr_scale = stable_spatial_lr_scale(opt_cfg, seg_len, extent)
        print(f"# stage3 spatial_lr_scale(auto) = {spatial_lr_scale:.4f} (lr/segment = "
              f"{opt_cfg.position_lr_init * spatial_lr_scale / max(seg_len, 1e-12):.4f})",
              flush=True)
    lr0 = opt_cfg.position_lr_init * float(spatial_lr_scale)
    if seg_len > 0 and lr0 / seg_len > 0.05:
        print(f"[warn] stage-3 dirs lr {lr0:.2e} is {lr0 / seg_len:.2f}x the mean "
              f"segment length {seg_len:.2e}; refinement diverged above ~0.05 at "
              f"L=100: consider spatial_lr_scale <= "
              f"{0.012 * seg_len / opt_cfg.position_lr_init:.3f}", flush=True)
    rng = random.Random(0)
    stack: list[int] = []
    logger = MetricsLogger(model_path_curves) if model_path_curves else None
    sds_gen = torch.Generator(device=device).manual_seed(sds_seed)
    for iteration in range(state.step + 1, opt_cfg.iterations + 1):
        if not stack:
            stack = list(range(len(cams)))
            rng.shuffle(stack)
        cam_idx = stack.pop(rng.randrange(len(stack)))
        draws = (draw_stage3(state.params, scfg, sds_gen, scfg.num_guiding_strands)
                 if use_sds else None)
        state, metrics = train_step(
            state, head, cam_batch, gt.image[cam_idx], gt.mask[cam_idx],
            gt.orient_angle[cam_idx], gt.orient_conf[cam_idx], cam_idx,
            cam_residuals, radius_scale, prior, draws,
            scfg=scfg, width=width, height=height, raster_cfg=raster_cfg,
            opt_cfg=opt_cfg, white_background=model_cfg.white_background,
            spatial_lr_scale=spatial_lr_scale, use_sds=use_sds)
        if logger and iteration % 10 == 0:
            logger.scalars(iteration, **{k: float(v) for k, v in metrics.items()})
        if progress_callback:
            progress_callback(iteration, state, metrics)
        if iteration in checkpoint_iterations and model_path_curves:
            save_checkpoint(state, os.path.join(model_path_curves, "checkpoints",
                                                f"{iteration}.npz"))
    if logger:
        logger.close()
    return state


def save_checkpoint(state: CurvesTrainState, path: str) -> None:
    """``p.*``, ``s.*``, ``mu.*``, ``nu.*``, ``count`` and ``step``: the JAX
    package's layout (gaussian_model_strands.py:86-110's capture)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob = {}
    for rec, pre in ((state.params, "p"), (state.static, "s"),
                     (state.opt.mu, "mu"), (state.opt.nu, "nu")):
        for name, v in zip(rec.names(), rec.values()):
            blob[f"{pre}.{name}"] = v.detach().cpu().numpy()
    blob["count"] = state.opt.count.cpu().numpy()
    blob["step"] = np.asarray(state.step, np.int32)
    np.savez(path, **blob)


def load_checkpoint(path: str, device=None) -> CurvesTrainState:
    """A stage-3 checkpoint of either package."""
    device = resolve_device(device)
    with np.load(path) as z:
        d = dict(z)
    get = lambda pre, cls: cls(**{n: torch.as_tensor(np.array(d[f"{pre}.{n}"], np.float32),
                                                     device=device) for n in cls.names()})
    count = torch.as_tensor(np.asarray(d["count"], np.int32), device=device)
    return CurvesTrainState(get("p", CurvesParams), get("s", CurvesStatic),
                            optim.AdamState(get("mu", CurvesParams),
                                            get("nu", CurvesParams), count),
                            int(d["step"]))


def export_points(state: CurvesTrainState) -> np.ndarray:
    """[N, L, 3] world-space strand polylines (the export_curves contract)."""
    with torch.no_grad():
        return curves_points(state.params, state.static).cpu().numpy()
