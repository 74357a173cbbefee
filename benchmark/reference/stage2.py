"""The reference stage-2 training step (GaussianHaircut's
``train_latent_strands.py:103-164`` with a self-trained latent diffusion
prior, as the pipeline runs it with ``--use_diffusion``).

One step: decode the drawn roots' strands from the texture, turn their
segments into Gaussians, composite them with the frozen head, take

  0.8 L1(render) + lambda_dmask L1(hair mask) + lambda_dorient OR(angle)
  + lambda_dsds L_diff

where L_diff trains the denoiser on the detached texture latent (the
texture's geometry channels averaged down to the diffusion grid) and, from
``diffusion_ema_warmup`` steps on, adds the frozen EMA copy's gradient of the
same loss to the texture; then clip the gradient to global norm
``hair_grad_clip``, take an AdamW step (lr on the cosine schedule from 1e-3
to 1e-4 over ``total_iters``) when every gradient is finite, and move the
EMA towards the new denoiser by ``1 - diffusion_ema_decay``.

The state is a dict: ``params``, ``mu``, ``nu``, ``ema`` (dicts of tensors
by parameter name; the EMA under the denoiser's names), ``count`` and
``step`` (ints).
"""
from __future__ import annotations

import math

import torch

from reference import geometry as geo
from reference import losses as L
from reference import optim
from reference import strands as S
from reference.render import Fields, background, render

DENOISER = "denoiser.net"


def view_camera(cams: dict, idx: int, cfg: dict) -> geo.Camera:
    """The view's stage-1 pose with its (zero) BARF residuals applied."""
    z = torch.zeros(3, device=cams["fovx"].device)
    return geo.camera(cams["colmap_transform"][idx], cams["fovx"][idx], cams["fovy"][idx],
                      cfg["width"], cfg["height"], z, z, z[:2])


def diffusion_loss(w: dict, ema: dict, draws: dict, cfg: dict, ema_weight: float | None):
    g, d = cfg["geometry_descriptor_size"], cfg["diffusion_input"]
    t = cfg["texture_size"] // d
    latent = lambda x: x.reshape(d, t, d, t, g).mean(dim=(1, 3))[None]
    tex = w["texture"][:, :, :g]
    unet = cfg["unet"]
    l_train = S.denoiser_loss(w, DENOISER, latent(tex.detach()), draws["noise"], draws["sigma"],
                              unet)
    if ema_weight is None:
        return l_train
    l_reg = S.denoiser_loss(ema, DENOISER, latent(tex), draws["noise"], draws["sigma"], unet)
    return l_train + ema_weight * (l_reg - l_reg.detach())


def losses(out: dict, gt: dict, idx: int, l_diff, opt: dict):
    image, mask = gt["image"][idx], gt["mask"][idx]
    lce = L.l1(out["mask"][:1], mask[:1])
    ll1 = L.l1(out["render"], image)
    weight = torch.ones_like(mask[:1]) * gt["orient_conf"][idx]
    lor = L.orientation(out["orient_angle"], gt["orient_angle"][idx], out["orient_conf"], weight,
                        mask[:1])
    ll1, lce, lor, ldf = (L.zero_nan(x) for x in (ll1, lce, lor, l_diff))
    return (ll1 * opt["lambda_dl1"] + lce * opt["lambda_dmask"] + lor * opt["lambda_dorient"]
            + ldf * opt["lambda_dsds"])


def step(state: dict, head: Fields, pool: dict, cams: dict, gt: dict, idx: int, draws: dict,
         cfg: dict) -> tuple:
    """-> (new state, loss as a float)."""
    opt = cfg["optimization"]
    w = {k: v.detach().requires_grad_() for k, v in state["params"].items()}
    hair = S.hair_fields(w, pool, draws["roots"], cfg, cfg["strand_radius"])
    out = render(Fields.cat(head, hair), cfg["sh_degree"], view_camera(cams, idx, cfg),
                 background(cfg["white_background"], w["texture"].device))
    ema_w = None
    if opt["diffusion_ema_warmup"] > 0:
        ema_w = float(state["step"] >= opt["diffusion_ema_warmup"])
    total = losses(out, gt, idx, diffusion_loss(w, state["ema"], draws, cfg, ema_w), opt)
    names = list(w)
    grads = torch.autograd.grad(total, [w[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(w[k]) if g is None else g for k, g in zip(names, grads)}
    new = dict(state)
    with torch.no_grad():
        ok = optim.finite(grads)
        if opt["hair_grad_clip"] > 0:
            grads = optim.clip_global_norm(grads, opt["hair_grad_clip"])
        base, total_iters = cfg["base_lr"], cfg["total_iters"]
        lr = 1e-4 + 0.5 * (base - 1e-4) * (1 + math.cos(math.pi * state["step"] / total_iters))
        if ok:
            p, m, v = optim.adamw(state["params"], grads, state["mu"], state["nu"],
                                  state["count"] + 1, lr)
            new.update(params=p, mu=m, nu=v, count=state["count"] + 1)
        dk = opt["diffusion_ema_decay"]
        new["ema"] = {k: dk * e + (1.0 - dk) * new["params"][k] for k, e in state["ema"].items()}
    new["step"] = state["step"] + 1
    return new, float(total.detach())
