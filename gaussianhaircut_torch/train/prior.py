"""The self-distilled SDS strand prior (port of
``gaussianhaircut_tpu/train/prior.py``).

Stage 3's SDS term needs a strand encoder and a latent denoiser
(gaussian_model_strands.py:456-515).  Without a converted upstream
checkpoint, this module makes them from a strand set: a FIXED strand encoder
drawn from a seed defines the latent space, and an EDM denoiser is trained
on HAAR-style latent images of random guiding-strand subsets
(``distill_strand_prior``).  ``pretrain_strand_decoder`` trains a strand
decoder to invert the same fixed encoder, the stand-in for the reference's
pretrained decoder that stage 2 warm-starts from.

Both return the module dicts that ``prior_io.save_prior``,
``stage2.warm_start`` and stage 3's ``prior`` take.  Each step's random draws
come from a ``torch.Generator`` seeded with ``seed``, or are given (one entry
per step): the parity tests pass the JAX package's draws, and its initial
weights through ``models/flax_params.py``.  Runs on CUDA unless
``device="cpu"`` is passed.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models.diffusion import (
    Denoiser, DiffusionConfig, sample_density, sds_latent_image,
)
from gaussianhaircut_torch.models.strand_prior import (
    GEOMETRY_DIM, StrandDecoder, StrandEncoder,
)
from gaussianhaircut_torch.train import optim


class PriorDraws(NamedTuple):
    """One distillation step's draws."""
    guides: torch.Tensor         # [G] int64 strand indices (with repeats)
    noise: torch.Tensor          # [1, D, D, 64]
    sigma: torch.Tensor          # [1]


def encode_strands(encoder: StrandEncoder, points: torch.Tensor, origins: torch.Tensor,
                   local2world: torch.Tensor, scale_decoder: float):
    """World polylines [N, L, 3] -> (z_geom [N, 64], v_local [N, L-1, 3]) in
    the encoder's local frame: the inverse of the generator's placement
    (gaussian_model_strands.py:456-473)."""
    inv_l2w = torch.linalg.inv(local2world)
    p_local = torch.einsum("nij,nlj->nli", inv_l2w, points - origins)
    z = encoder(p_local * scale_decoder)[:, :GEOMETRY_DIM]
    v_local = (p_local[:, 1:] - p_local[:, :-1]) * scale_decoder
    return z, v_local


def fixed_encoder(length: int, encoder_seed: int = 11) -> StrandEncoder:
    """The fixed encoder that defines the latent space, drawn with flax's
    initialisers from a CPU generator seeded with ``encoder_seed``."""
    return StrandEncoder(length=length).init_weights(torch.Generator().manual_seed(encoder_seed))


def _as_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(device)


def _adam_steps(module: torch.nn.Module, loss_of_step, steps: int, lr: float,
                progress_callback=None):
    """``steps`` Adam steps (eps 1e-15, the JAX package's ``adam_update``) on
    every parameter of ``module``, in place.  Returns the first and the last
    loss as device scalars."""
    names, leaves = zip(*module.named_parameters())
    opt = optim.adam_init(dict(zip(names, (p.detach() for p in leaves))))
    lrs = {n: lr for n in names}
    first = last = None
    for i in range(steps):
        loss = loss_of_step(i)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        with torch.no_grad():
            updates, opt = optim.adam_update(grads, opt, lrs)
            for n, p in zip(names, leaves):
                p.add_(updates[n])
        last = loss.detach()
        if first is None:
            first = last
        if progress_callback is not None:
            progress_callback(i, float(last))
    return first, last


def _rounded(t, digits: int):
    return None if t is None else round(float(t), digits)


def pretrain_strand_decoder(points, local2world, scfg, *, steps: int, seed: int = 0,
                            lr: float = 1e-3, batch: int = 512, encoder_seed: int = 11,
                            encoder: StrandEncoder | None = None,
                            decoder: StrandDecoder | None = None,
                            draws: Sequence[torch.Tensor] | None = None,
                            device=None) -> tuple[dict, dict]:
    """Train a StrandDecoder to invert the fixed StrandEncoder on a strand
    set, ``steps`` Adam steps on batches of ``batch`` strands (drawn with
    repeats).  points [N, L, 3] world, local2world [N, 3, 3].

    ``encoder`` / ``decoder`` replace the seeded fixed encoder and the
    decoder's fresh initial weights (drawn from a CPU generator seeded with
    ``seed``); ``draws`` gives each step's batch indices.  Returns
    ({"decoder": StrandDecoder}, info)."""
    device = resolve_device(device)
    points = _as_tensor(points, device)
    local2world = _as_tensor(local2world, device)
    n, length = points.shape[0], points.shape[1]
    encoder = (encoder or fixed_encoder(length, encoder_seed)).to(device).requires_grad_(False)
    with torch.no_grad():
        z_all, v_local = encode_strands(encoder, points, points[:, :1], local2world,
                                        scfg.scale_decoder)
    if decoder is None:
        decoder = StrandDecoder(length=length).init_weights(torch.Generator().manual_seed(seed))
    decoder = decoder.to(device)
    bs = min(batch, n)
    gen = torch.Generator(device=device).manual_seed(seed)

    def loss_of_step(i):
        idx = (draws[i] if draws is not None
               else torch.randint(0, n, (bs,), generator=gen, device=device)).to(device)
        return torch.mean((decoder(z_all[idx]) - v_local[idx]) ** 2)

    l0, lval = _adam_steps(decoder, loss_of_step, steps, lr)
    info = {"decoder_pretrain_loss_start": _rounded(l0, 5),
            "decoder_pretrain_loss_end": _rounded(lval, 5),
            "decoder_pretrain_steps": steps}
    return {"decoder": decoder}, info


def draw_prior(n: int, num_guiding: int, cfg: DiffusionConfig,
               generator: torch.Generator) -> PriorDraws:
    """Guiding strands (with repeats, as ``jax.random.randint``), noise and
    sigma from ``generator``."""
    dev = generator.device
    guides = torch.randint(0, n, (min(num_guiding, n),), generator=generator, device=dev)
    d = cfg.input_size
    noise = torch.randn((1, d, d, cfg.input_channels), generator=generator, device=dev)
    return PriorDraws(guides, noise, sample_density(cfg, (1,), generator))


def _latent_loss(denoiser: Denoiser, z_all, uvs_pm1, v_local, scfg, dr: PriorDraws):
    """The denoiser's loss on the latent image of the guiding strands
    ``dr.guides`` (a constant of the strand set: no gradient to it)."""
    device = z_all.device
    idx = dr.guides.to(device)
    with torch.no_grad():
        x0 = sds_latent_image(z_all[idx], uvs_pm1[idx], v_local[idx], scfg.diffusion_input)[None]
    return denoiser.loss(x0, dr.noise.to(device), dr.sigma.to(device))


@torch.no_grad()
def prior_loss(prior: dict, points, uvs, local2world, scfg, draws: Sequence[PriorDraws],
               device=None) -> float:
    """The mean denoiser loss of ``prior`` ({"encoder", "denoiser"}) over
    the given draws on a strand set: a fixed yardstick for a prior before
    and after distillation."""
    device = resolve_device(device)
    points = _as_tensor(points, device)
    z_all, v_local = encode_strands(prior["encoder"], points, points[:, :1],
                                    _as_tensor(local2world, device), scfg.scale_decoder)
    uvs_pm1 = 2.0 * _as_tensor(uvs, device) - 1.0
    return float(torch.stack([_latent_loss(prior["denoiser"], z_all, uvs_pm1, v_local, scfg, dr)
                              for dr in draws]).mean())


def distill_strand_prior(points, uvs, local2world, scfg, *, steps: int, seed: int = 0,
                         lr: float = 1e-4, num_guiding: int = 1000, encoder_seed: int = 11,
                         encoder: StrandEncoder | None = None,
                         denoiser: Denoiser | None = None,
                         draws: Sequence[PriorDraws] | None = None,
                         progress_callback=None, device=None) -> tuple[dict, dict]:
    """Train ``{"encoder", "denoiser"}`` on a strand set.

    points [N, L, 3] world; uvs [N, 2] in [0, 1]; local2world [N, 3, 3].
    The encoder is fixed (``fixed_encoder(L, encoder_seed)`` unless given);
    the denoiser (fresh weights from a CPU generator seeded with ``seed``
    unless given) takes ``steps`` Adam steps on latent images of
    ``num_guiding``-strand subsets, each step's draws from a generator
    seeded with ``seed`` or from ``draws``.  ``progress_callback(i, loss)``
    after every step (a host sync).  Returns (prior, info) with the first
    and the last denoiser loss."""
    device = resolve_device(device)
    points = _as_tensor(points, device)
    local2world = _as_tensor(local2world, device)
    uvs_pm1 = 2.0 * _as_tensor(uvs, device) - 1.0
    n, length = points.shape[0], points.shape[1]
    encoder = (encoder or fixed_encoder(length, encoder_seed)).to(device).requires_grad_(False)
    with torch.no_grad():
        z_all, v_local = encode_strands(encoder, points, points[:, :1], local2world,
                                        scfg.scale_decoder)
    cfg = DiffusionConfig(input_channels=GEOMETRY_DIM, input_size=scfg.diffusion_input)
    if denoiser is None:
        denoiser = Denoiser(cfg).init_weights(torch.Generator().manual_seed(seed))
    denoiser = denoiser.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def loss_of_step(i):
        dr = draws[i] if draws is not None else draw_prior(n, num_guiding, cfg, gen)
        return _latent_loss(denoiser, z_all, uvs_pm1, v_local, scfg, dr)

    l0, lval = _adam_steps(denoiser, loss_of_step, steps, lr, progress_callback)
    info = {"prior_loss_start": _rounded(l0, 4), "prior_loss_end": _rounded(lval, 4),
            "prior_steps": steps}
    return {"encoder": encoder, "denoiser": denoiser}, info
