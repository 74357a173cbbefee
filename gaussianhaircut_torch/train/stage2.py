"""Stage-2 trainer: latent textured strands over a frozen head (port of
``gaussianhaircut_tpu/train/stage2.py``; reference
src/train_latent_strands.py).

Each iteration (reference :103-164) regenerates the strands from the scalp
texture and the decoder, turns their segments into hair Gaussians, composites
them with the frozen stage-1 head (the label < 0.5 split, :67-75) through
``render_fields`` (so the compositing kernels), and minimises

  loss = lambda_dl1 * L1(image) + lambda_dmask * L1(hair mask)
       + lambda_dorient * OR(orient | conf, gt-conf weight, hair mask)
       + lambda_dsds * L_diff                                  (:130-152)

by AdamW with a cosine LR over the texture, the strand decoder, the colour
decoder and (self-trained prior) the denoiser.  Cameras stay at their
stage-1 poses.

The random draws of a step (the roots, the diffusion sigma and noise) come
from the state's ``torch.Generator``, or are given as ``Stage2Draws`` (the
parity tests pass the JAX package's).  The parameters, the EMA and the
optimizer state are updated in place, on the card in one fused pass
(``train/optim_tail.py``).  The JAX package's
static instance buffer and its grow / shrink loops have no counterpart: the
binning sizes its buffer from ``num_rendered`` on every call, and
``num_rendered`` stays in the metrics.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os
import random
from typing import NamedTuple

import numpy as np
import torch

from gaussianhaircut_torch.config import OptimizationConfig
from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.models.diffusion import Denoiser, DiffusionConfig, sample_density
from gaussianhaircut_torch.models.flax_params import (
    flax_names, from_flax_layout, load_flax_, to_flax, to_flax_layout,
)
from gaussianhaircut_torch.models.strand_prior import ColorDecoder
from gaussianhaircut_torch.models.strands import per_segment, strands_to_gaussians
from gaussianhaircut_torch.models.textured_strands import (
    ScalpPool, StrandParams, TexturedStrandsConfig, generate_strands, init_params,
    sample_roots,
)
from gaussianhaircut_torch.ops import losses as L
from gaussianhaircut_torch.ops.quaternion import build_rotation
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.render.renderer import (
    GaussianFields, default_background, render_fields,
)
from gaussianhaircut_torch.scene.cameras import CameraBatch, camera_geom
from gaussianhaircut_torch.train import optim, optim_tail
from gaussianhaircut_torch.utils.logger import MetricsLogger


@dataclasses.dataclass
class HairTrainState:
    params: StrandParams              # texture, decoder, color_decoder [, denoiser]
    opt: optim.AdamState              # moments keyed by parameter name
    step: int
    generator: torch.Generator        # the step's random draws
    ema: Denoiser | None = None       # EMA copy of params.denoiser (self-
                                      # trained prior only): the frozen
                                      # regularizer that pulls the texture
                                      # once warmed up (model_ema,
                                      # gaussian_model_latent_strands.py:501-513)


class Stage2Draws(NamedTuple):
    """One step's random draws."""
    roots: torch.Tensor        # [num_strands] int64 distinct pool indices
    sigma: torch.Tensor        # [1] diffusion noise level
    noise: torch.Tensor        # [1, D, D, 64] diffusion noise


def diffusion_config(scfg: TexturedStrandsConfig) -> DiffusionConfig:
    return DiffusionConfig(input_channels=scfg.geometry_descriptor_size,
                           input_size=scfg.diffusion_input)


def generator_from_key(key, device) -> torch.Generator:
    """A generator seeded from a checkpoint's uint32[2] ``key``."""
    key = np.asarray(key, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(key[0]) << 32 | int(key[1])) & ((1 << 63) - 1))
    return gen


def next_key(gen: torch.Generator) -> np.ndarray:
    """A uint32[2] key drawn from ``gen`` without advancing it: the
    checkpoint's ``key``, from which a resumed run seeds its generator."""
    st = gen.get_state()
    key = torch.randint(0, 1 << 32, (2,), generator=gen, device=gen.device)
    gen.set_state(st)
    return key.cpu().numpy().astype(np.uint32)


def make_head_fields(state: gm.GaussianModelState) -> GaussianFields:
    """The frozen head: stage-1 rows alive with hair label < 0.5
    (train_latent_strands.py:67-75), at full capacity with a validity mask;
    label, direction and confidence forced to the head convention
    (gaussian_renderer/__init__.py:172-175)."""
    p = state.params
    with torch.no_grad():
        return GaussianFields(
            xyz=p.xyz.detach(),
            features=gm.get_features(p),
            scaling=gm.get_scaling(p),
            rotation_matrix=build_rotation(p.rotation),
            opacity=gm.get_opacity(p),
            label=torch.zeros_like(p.label),
            orient_conf=torch.zeros_like(p.orient_conf),
            valid=state.aux.alive & (gm.get_label(p)[:, 0] < 0.5),
            viewspace=torch.zeros_like(p.xyz),
            use_direction=torch.zeros(p.xyz.shape[0], device=p.xyz.device),
        )


def init_hair_state(scfg: TexturedStrandsConfig, seed: int = 0,
                    own_denoiser: bool = True, device=None) -> HairTrainState:
    """Fresh parameters drawn with flax's initialisers from a CPU generator
    seeded with ``seed`` (texture and decoder, colour decoder, denoiser,
    then the step generator's key).  ``own_denoiser=False`` leaves out the
    jointly trained denoiser (a frozen pretrained one is given to train())."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(scfg, gen)
    params.color_decoder = ColorDecoder(sh_degree=scfg.sh_degree).init_weights(gen)
    if scfg.use_diffusion and own_denoiser:
        params.denoiser = Denoiser(diffusion_config(scfg)).init_weights(gen)
    key = torch.randint(0, 1 << 32, (2,), generator=gen).numpy()
    params.to(device)
    ema = (copy.deepcopy(params.denoiser).requires_grad_(False)
           if params.denoiser is not None else None)
    return HairTrainState(params, optim.adam_init(dict(params.named_parameters())), 0,
                          generator_from_key(key, device), ema)


def warm_start(state: HairTrainState, prior: dict) -> HairTrainState:
    """Start the trainable strand decoder from a prior's decoder
    (gaussian_model_latent_strands.py:517-519); the decoder stays trainable.
    A decoder of another shape is an error, not a partial load."""
    dec = prior.get("decoder")
    if dec is None:
        return state
    cur = state.params.decoder.state_dict()
    new = dec.state_dict()
    if {k: v.shape for k, v in cur.items()} != {k: v.shape for k, v in new.items()}:
        raise ValueError("prior decoder does not match StrandDecoder: "
                         f"{ {k: tuple(v.shape) for k, v in new.items()} }")
    state.params.decoder.load_state_dict(new)
    print("[stage2] warm_start: strand decoder initialized from the prior")
    return dataclasses.replace(
        state, opt=optim.adam_init(dict(state.params.named_parameters())))


def diffusion_loss(params: StrandParams, scfg: TexturedStrandsConfig,
                   sigma: torch.Tensor, noise: torch.Tensor, diffuse_mask=None,
                   denoiser: Denoiser | None = None, ema: Denoiser | None = None,
                   ema_weight: float | None = None) -> torch.Tensor:
    """L_diff over the texture's geometry channels averaged down to the
    diffusion grid (gaussian_model_latent_strands.py:501-504).

    With ``denoiser`` (a pretrained one) it is frozen.  Otherwise
    ``params.denoiser`` learns the texture's latent distribution from a
    detached latent (a from-scratch denoiser's early loss would drag the
    texture around); the texture is pulled only by the frozen ``ema``,
    through ``ema_weight * (l_reg - l_reg.detach())``, which adds its
    gradient and nothing to the value."""
    g = scfg.geometry_descriptor_size
    tex = params.texture[:, :, :g]
    d = scfg.diffusion_input
    t = scfg.texture_size // d

    def latent_of(x):
        return x.reshape(d, t, d, t, g).mean(dim=(1, 3))[None]

    mask = None if diffuse_mask is None else diffuse_mask[None, :, :, None]
    if denoiser is not None:
        return denoiser.loss(latent_of(tex), noise, sigma, mask)
    l_train = params.denoiser.loss(latent_of(tex.detach()), noise, sigma, mask)
    if ema is None or ema_weight is None:
        return l_train
    l_reg = ema.loss(latent_of(tex), noise, sigma, mask)
    return l_train + ema_weight * (l_reg - l_reg.detach())


def hair_fields_from_strands(params: StrandParams, pool: ScalpPool,
                             scfg: TexturedStrandsConfig, roots: torch.Tensor,
                             radius_scale):
    """Strands -> segment-Gaussian fields, with per-strand colour and
    confidence from the colour decoder (gaussian_model_latent_strands.py:
    442-504).  Returns (fields, strands)."""
    strands = generate_strands(params, pool, scfg, roots)
    sg = strands_to_gaussians(strands.points, radius_scale)
    n, s = strands.points.shape[0], strands.points.shape[1] - 1
    k = (scfg.sh_degree + 1) ** 2
    out = params.color_decoder(strands.z_app)                  # [N, 3k+1]
    features = torch.cat([per_segment(out[:, :3].reshape(n, 1, 3), s),
                          per_segment(out[:, 3:3 * k].reshape(n, k - 1, 3), s)], dim=1)
    # clamped exp, as gaussian_model.get_orient_conf
    orient_conf = torch.exp(torch.clamp(per_segment(out[:, 3 * k:], s), -30.0, 30.0))
    ones = torch.ones((n * s, 1), device=out.device)
    fields = GaussianFields(
        xyz=sg.xyz, features=features, scaling=sg.scaling,
        rotation_matrix=sg.rotation_matrix, opacity=ones, label=ones,
        orient_conf=orient_conf,
        valid=torch.ones(n * s, dtype=torch.bool, device=out.device),
        viewspace=torch.zeros((n * s, 3), device=out.device),
        use_direction=torch.ones(n * s, device=out.device))
    return fields, strands


def concat_fields(head: GaussianFields, hair: GaussianFields) -> GaussianFields:
    return GaussianFields(**{f.name: torch.cat([getattr(head, f.name), getattr(hair, f.name)])
                             for f in dataclasses.fields(GaussianFields)})


def stage2_losses(out, gt_image, gt_mask, gt_orient_angle, gt_orient_conf,
                  l_diff, opt_cfg: OptimizationConfig):
    """train_latent_strands.py:130-152; a NaN term counts as 0."""
    lce = L.l1_loss(out["mask"][:1], gt_mask[:1])
    ll1 = L.l1_loss(out["render"], gt_image)
    orient_weight = torch.ones_like(gt_mask[:1])
    if opt_cfg.use_gt_orient_conf:
        orient_weight = orient_weight * gt_orient_conf
    confs = out["orient_conf"] if opt_cfg.train_orient_conf else None
    lor = L.or_loss(out["orient_angle"], gt_orient_angle, confs=confs,
                    weight=orient_weight, mask=gt_mask[:1])
    zero_nan = lambda x: torch.where(torch.isnan(x), torch.zeros_like(x), x)
    ll1, lce, lor, ldf = (zero_nan(x) for x in (ll1, lce, lor, l_diff))
    total = (ll1 * opt_cfg.lambda_dl1 + lce * opt_cfg.lambda_dmask
             + lor * opt_cfg.lambda_dorient + ldf * opt_cfg.lambda_dsds)
    return total, {"l1": ll1, "mask": lce, "orient": lor, "sds": ldf, "total": total}


def draw_stage2(state: HairTrainState, pool: ScalpPool,
                scfg: TexturedStrandsConfig) -> Stage2Draws:
    """The step's draws from the state's generator: roots, sigma, noise."""
    gen = state.generator
    roots = sample_roots(pool, scfg.num_strands, gen)
    sigma = sample_density(diffusion_config(scfg), (1,), gen)
    d, g = scfg.diffusion_input, scfg.geometry_descriptor_size
    noise = torch.randn((1, d, d, g), generator=gen, device=gen.device)
    return Stage2Draws(roots, sigma, noise)


def train_step(state: HairTrainState, head: GaussianFields, pool: ScalpPool,
               cam_batch: CameraBatch, gt_image, gt_mask, gt_orient_angle,
               gt_orient_conf, cam_idx: int, cam_residuals, radius_scale,
               denoiser: Denoiser | None = None, diffuse_mask=None, *,
               scfg: TexturedStrandsConfig, width: int, height: int,
               raster_cfg: RasterConfig, opt_cfg: OptimizationConfig,
               white_background: bool, base_lr: float = 1e-3,
               total_iters: int = 20000, draws: Stage2Draws | None = None):
    """One stage-2 step.  Returns (state, metrics): the parameters, the EMA
    and the optimizer state are updated in place (``optim_tail.adamw_tail_``),
    the rest is new; metrics hold device scalars, ``num_rendered``,
    ``num_rendered_3sigma`` (the instances that the reference's 3-sigma tile
    rect would bin), ``opt_tail_leaves`` and ``precompute_gaussians`` (ints:
    the leaves the fused optimizer pass covered and the Gaussians the
    precompute's kernel covered, 0 on the CPU)."""
    device = state.params.texture.device
    bg = default_background(white_background, device)
    if draws is None:
        draws = draw_stage2(state, pool, scfg)
    cam = camera_geom(cam_batch.colmap_transform[cam_idx], cam_batch.fovx[cam_idx],
                      cam_batch.fovy[cam_idx], width, height, cam_residuals, cam_idx)
    # the EMA's texture pull starts after its warmup (self-trained prior)
    ema_w = None
    if state.ema is not None and opt_cfg.diffusion_ema_warmup > 0:
        ema_w = float(state.step >= opt_cfg.diffusion_ema_warmup)

    names, leaves = zip(*state.params.named_parameters())
    hair, _ = hair_fields_from_strands(state.params, pool, scfg, draws.roots, radius_scale)
    out = render_fields(concat_fields(head, hair), scfg.sh_degree, cam, bg, raster_cfg)
    l_diff = (diffusion_loss(state.params, scfg, draws.sigma, draws.noise, diffuse_mask,
                             denoiser, state.ema, ema_w)
              if scfg.use_diffusion else torch.zeros((), device=device))
    total, parts = stage2_losses(out, gt_image, gt_mask, gt_orient_angle,
                                 gt_orient_conf, l_diff, opt_cfg)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, leaves, grads)}

    # CosineAnnealingLR(T_max=iters, eta_min=1e-4) (gaussian_model_latent_strands.py:519)
    lr = 1e-4 + 0.5 * (base_lr - 1e-4) * (1 + math.cos(math.pi * state.step / total_iters))
    ema_pairs = ([] if state.ema is None else
                 list(zip(state.ema.parameters(), state.params.denoiser.parameters())))
    tail = optim_tail.adamw_tail_(dict(zip(names, leaves)), grads, state.opt, ema_pairs, lr,
                                  opt_cfg.hair_grad_clip, decay=opt_cfg.diffusion_ema_decay)
    if opt_cfg.hair_grad_clip > 0:
        parts["grad_norm"] = tail.grad_norm
    metrics = {k: v.detach() for k, v in parts.items()}
    metrics["num_rendered"] = out["num_rendered"]
    metrics["num_rendered_3sigma"] = out["num_rendered_3sigma"]
    metrics["opt_tail_leaves"] = tail.fused_leaves
    metrics["precompute_gaussians"] = out["precompute_gaussians"]
    return dataclasses.replace(state, step=state.step + 1), metrics


def train(model_cfg, opt_cfg: OptimizationConfig, scfg: TexturedStrandsConfig,
          pipe_cfg, scene, head_model: gm.GaussianModelState, pool: ScalpPool,
          scene_scale, cam_residuals=None, *, model_path_hair: str = "",
          checkpoint_iterations=(20000,), start_checkpoint=None,
          denoiser: Denoiser | None = None, diffuse_mask=None, prior: dict | None = None,
          progress_callback=None, device=None) -> HairTrainState:
    """The host loop (train_latent_strands.py:87-181); runs on CUDA unless
    ``device="cpu"`` is passed.

    denoiser: a frozen pretrained denoiser; without one, ``scfg.use_diffusion``
    trains a self-prior denoiser jointly.  prior: the modules of
    ``prior_io.load_prior``; its decoder warm-starts the strand decoder.
    Camera draws follow the JAX package (``random.Random(0)`` epochs); every
    10 iterations the metrics go to ``metrics.jsonl``."""
    device = resolve_device(device)
    from gaussianhaircut_torch.train.stage1 import GtBatch
    cams = scene.train_cameras
    width, height = cams[0].width, cams[0].height
    cam_batch = CameraBatch.from_cameras(cams, device)
    gt = GtBatch.from_cameras(cams, device)
    head = make_head_fields(head_model)
    pool = pool.to(device)

    state = init_hair_state(scfg, 0, own_denoiser=denoiser is None, device=device)
    if prior is not None:
        state = warm_start(state, prior)
    if start_checkpoint:
        state = load_checkpoint(start_checkpoint, state)
    raster_cfg = RasterConfig(tile_w=pipe_cfg.tile, tile_h=pipe_cfg.tile)
    radius_scale = torch.tensor(model_cfg.strand_scale * float(scene_scale),
                                dtype=torch.float32, device=device)
    logger = MetricsLogger(model_path_hair) if model_path_hair else None
    rng = random.Random(0)
    stack: list[int] = []
    for iteration in range(state.step + 1, opt_cfg.iterations + 1):
        if not stack:
            stack = list(range(len(cams)))
            rng.shuffle(stack)
        cam_idx = stack.pop(rng.randrange(len(stack)))
        state, metrics = train_step(
            state, head, pool, cam_batch, gt.image[cam_idx], gt.mask[cam_idx],
            gt.orient_angle[cam_idx], gt.orient_conf[cam_idx], cam_idx,
            cam_residuals, radius_scale, denoiser, diffuse_mask,
            scfg=scfg, width=width, height=height, raster_cfg=raster_cfg,
            opt_cfg=opt_cfg, white_background=model_cfg.white_background,
            total_iters=opt_cfg.iterations)
        if logger and iteration % 10 == 0:
            logger.scalars(iteration, **{k: float(v) for k, v in metrics.items()})
        if progress_callback:
            progress_callback(iteration, state, metrics)
        if iteration in checkpoint_iterations and model_path_hair:
            save_checkpoint(state, os.path.join(model_path_hair, "checkpoints",
                                                f"{iteration}.npz"))
    if logger:
        logger.close()
    return state


# ------------------------------------------------------------ checkpoints --

def hair_flax_keys(params: StrandParams) -> dict[str, tuple[str, str]]:
    """Parameter name -> (key below the checkpoint's section prefix,
    layout): ``texture``, ``decoder/params/...``, ``color_decoder/params/...``
    and ``denoiser/params/...``, the JAX package's key paths."""
    out = {"texture": ("texture", "same")}
    for section in ("decoder", "color_decoder", "denoiser"):
        mod = getattr(params, section)
        if mod is None:
            continue
        tprefix = section + "."
        if section == "denoiser":
            mod, tprefix = mod.net, "denoiser.net."
        for name, (path, layout) in flax_names(mod).items():
            out[tprefix + name] = (f"{section}/params/{path}", layout)
    return out


def save_checkpoint(state: HairTrainState, path: str) -> None:
    """The JAX package's npz layout: ``params/...``, ``mu/...``, ``nu/...``
    (flax key paths and layouts), ``ema/...``, ``opt_count``, ``step`` and
    a uint32[2] ``key``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    keys = hair_flax_keys(state.params)
    params = dict(state.params.named_parameters())
    blob = {}
    for tree, pre in ((params, "params"), (state.opt.mu, "mu"), (state.opt.nu, "nu")):
        blob.update({f"{pre}/{k}": to_flax_layout(tree[name], layout)
                     for name, (k, layout) in keys.items()})
    if state.ema is not None:
        blob.update(to_flax(state.ema.net, prefix="ema/params"))
    blob["opt_count"] = state.opt.count.cpu().numpy()
    blob["step"] = np.asarray(state.step, np.int32)
    blob["key"] = next_key(state.generator)
    np.savez(path, **blob)


def load_checkpoint(path: str, template: HairTrainState) -> HairTrainState:
    """Load a checkpoint of either package into ``template`` (its parameters
    are overwritten in place).  Sections the template lacks (a jointly
    trained denoiser when a frozen one is used) are ignored; leaves the
    checkpoint lacks keep their initial values, with a warning."""
    with np.load(path) as z:
        d = dict(z)
    keys = hair_flax_keys(template.params)
    device = template.params.texture.device

    def fill(prefix: str, current: dict) -> dict:
        out, missing = {}, []
        for name, (k, layout) in keys.items():
            key = f"{prefix}/{k}"
            if key not in d:
                missing.append(key)
                out[name] = current[name]
                continue
            a = torch.as_tensor(from_flax_layout(np.array(d[key], np.float32), layout),
                                device=device)
            if a.shape != current[name].shape:
                raise ValueError(f"{path}: {key} has shape {tuple(a.shape)}, "
                                 f"expected {tuple(current[name].shape)}")
            out[name] = a
        if missing:
            print(f"[warn] checkpoint {path} lacks {len(missing)} leaves "
                  f"(e.g. {missing[0]}); keeping init values")
        return out

    params = dict(template.params.named_parameters())
    with torch.no_grad():
        for name, t in fill("params", params).items():
            params[name].copy_(t)
    mu = fill("mu", template.opt.mu)
    nu = fill("nu", template.opt.nu)
    ema = template.ema
    if ema is not None:
        if any(k.startswith("ema/") for k in d):
            load_flax_(ema.net, d, prefix="ema/params")
        elif template.params.denoiser is not None:
            # a checkpoint without an EMA: seed it from the loaded denoiser
            ema = copy.deepcopy(template.params.denoiser).requires_grad_(False)
    count = torch.as_tensor(np.asarray(d["opt_count"], np.int32), device=device)
    return HairTrainState(template.params, optim.AdamState(mu, nu, count),
                          int(d["step"]), generator_from_key(d["key"], device), ema)
