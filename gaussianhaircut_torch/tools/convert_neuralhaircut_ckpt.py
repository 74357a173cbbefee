"""Converter: NeuralHaircut's pretrained priors -> the strand-prior npz (port
of ``tools/convert_neuralhaircut_ckpt.py``; the same flags and schema).

The reference depends on two pretrained artifacts fetched at install time
(install.sh:28; gaussian_model_strands.py:80-81): the strand VAE
``strand_ckpt.pth`` (Encoder / Decoder of
ext/NeuralHaircut/src/hair_networks/strand_prior.py) and, optionally, the
latent hair-texture denoiser (k-diffusion image_v1).  The port's networks
(``models/strand_prior.py``, ``models/diffusion.py``) have other
topologies, so the weights move by distillation: the upstream modules are
sampled and the port's modules fitted to them by MSE with Adam.  The npz is
``models/prior_io.save_prior``'s, the JAX package's format; it is read by
``load_prior`` / ``--prior_checkpoint`` of either package.

The teachers are sampled as in the JAX tool: unit-normal latents for the
decoder; strands decoded by the teacher and summed up from the root for the
encoder; 32x32x64 latent images with ``sigma = exp(N(-1.2, 1.2))`` for the
denoiser.  The numpy draws come from ``default_rng(seed)``, the students'
initial weights from a seeded ``torch.Generator``.  Only
``src.hair_networks.strand_prior`` is imported from the upstream tree, so
a package that module needs and this machine lacks is named by its
ImportError.  ``--diffusion_ckpt`` holds a pickled module (the upstream
checkpoint's ``model_ema`` entry, or the whole file), so that file is
unpickled in full: give only a checkpoint you trust.  Runs on CUDA unless
``--device cpu`` is given.

    python3 -m gaussianhaircut_torch.tools.convert_neuralhaircut_ckpt \\
        --neuralhaircut_dir ext/NeuralHaircut \\
        --strand_ckpt ext/NeuralHaircut/pretrained_models/strand_prior/strand_ckpt.pth \\
        --out weights/strand_prior.npz [--steps 2000] [--batch 512]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
from torch import nn

from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.models.diffusion import Denoiser, DiffusionConfig
from gaussianhaircut_torch.models.prior_io import load_prior, save_prior
from gaussianhaircut_torch.models.strand_prior import (
    GEOMETRY_DIM, MLP, StrandDecoder, StrandEncoder,
)


def _distill(student: nn.Module, fn_teacher, sample_inputs, steps: int, batch: int,
             lr: float = 1e-3, seed: int = 0, label: str = "") -> nn.Module:
    """Fit ``student(x)`` to ``fn_teacher(x)`` by MSE with Adam over
    ``x = sample_inputs(rng, batch)``, ``rng = default_rng(seed)``."""
    student.requires_grad_(True)
    opt = torch.optim.Adam(student.parameters(), lr=lr)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        x = sample_inputs(rng, batch)
        with torch.no_grad():
            y = fn_teacher(x)
        loss = torch.mean((student(x) - y) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 100 == 0:
            print(f"[{label}] step {i}: mse={loss.item():.6f}", flush=True)
    return student.requires_grad_(False)


def selftest(device=None) -> int:
    """No upstream file: (1) the distillation fits a known tanh-MLP teacher
    into a 128-128 silu student out of sample (relative MSE < 0.08); (2)
    the prior npz round-trips the port's encoder and decoder."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    w1 = rng.normal(scale=0.15, size=(GEOMETRY_DIM, 32)).astype(np.float32)
    b1 = rng.normal(scale=0.1, size=(32,)).astype(np.float32)
    w2 = rng.normal(scale=0.4, size=(32, 6)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    w1_t, b1_t, w2_t = t(w1), t(b1), t(w2)

    def teacher(z):
        return torch.tanh(z @ w1_t + b1_t) @ w2_t

    gen = torch.Generator().manual_seed(1)
    student = MLP(GEOMETRY_DIM, (128, 128, 6)).init_weights(gen).to(device)
    fitted = _distill(student, teacher,
                      lambda r, n: t(r.normal(size=(n, GEOMETRY_DIM)).astype(np.float32)),
                      steps=800, batch=256, lr=3e-3, label="selftest")
    holdout = t(np.random.default_rng(123).normal(size=(512, GEOMETRY_DIM)).astype(np.float32))
    with torch.no_grad():
        pred, gold = fitted(holdout), teacher(holdout)
    rel = float(torch.mean((pred - gold) ** 2) / torch.mean(gold ** 2))

    length = 16
    prior = {"encoder": StrandEncoder(length=length).init_weights(torch.Generator().manual_seed(2)),
             "decoder": StrandDecoder(length=length).init_weights(
                 torch.Generator().manual_seed(3))}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "prior.npz")
        save_prior(path, prior)
        back = load_prior(path, strand_length=length)
    same = all(torch.equal(a, b) for name in prior
               for a, b in zip(prior[name].state_dict().values(),
                               back[name].state_dict().values()))
    ok = rel < 0.08 and same
    print(f"selftest: distill rel-mse={rel:.4f} roundtrip={same} ->", "OK" if ok else "FAILED")
    return 0 if ok else 1


class _Denoise(nn.Module):
    """The student denoiser on the teacher's input: [N, 32, 32, C + 1] with
    sigma broadcast into the last channel."""

    def __init__(self, den: Denoiser):
        super().__init__()
        self.den = den

    def forward(self, xin):
        return self.den.denoise(xin[..., :-1], xin[:, 0, 0, -1])


def convert(neuralhaircut_dir: str, strand_ckpt: str, out: str, steps: int = 2000,
            batch: int = 512, strand_length: int = 100, diffusion_ckpt: str = "",
            device=None) -> dict:
    """Distill the upstream strand VAE (and the denoiser of
    ``diffusion_ckpt``) into the port's modules and save them at ``out``;
    returns {"encoder", "decoder"[, "denoiser"]}."""
    device = resolve_device(device)
    sys.path.insert(0, neuralhaircut_dir)
    from src.hair_networks.strand_prior import Decoder, Encoder  # upstream

    ckpt = torch.load(strand_ckpt, map_location="cpu", weights_only=True)
    enc_t = Encoder(None).eval()
    enc_t.load_state_dict(ckpt["encoder"])
    dec_t = Decoder(None).eval()
    dec_t.load_state_dict(ckpt["decoder"])
    enc_t.to(device)
    dec_t.to(device)
    t = lambda a: torch.as_tensor(a, device=device)
    length = strand_length

    # ---- decoder: geometry latent [64] -> local segment vectors [L-1, 3] ----
    def sample_latents(rng, n):
        # the VAE prior: unit-normal latents
        return t(rng.normal(size=(n, GEOMETRY_DIM)).astype(np.float32))

    def teach_decode(z):
        out = dec_t(z)
        pts = out[0] if isinstance(out, (tuple, list)) else out   # [N, L, 3]
        pts = pts.reshape(len(z), -1, 3)
        return pts[:, 1:] - pts[:, :-1]

    dec = StrandDecoder(length=length).init_weights(torch.Generator().manual_seed(0)).to(device)
    dec = _distill(dec, teach_decode, sample_latents, steps, batch, label="decoder")

    # ---- encoder: local points [L, 3] -> latent (the first 64 are geometry) ----
    enc = StrandEncoder(length=length).init_weights(torch.Generator().manual_seed(1)).to(device)

    def sample_strands(rng, n):
        with torch.no_grad():
            segs = teach_decode(sample_latents(rng, n))
        return torch.cat([torch.zeros_like(segs[:, :1]), torch.cumsum(segs, dim=1)], dim=1)

    def teach_encode(pts):
        z = enc_t(pts)
        want = enc.out.out_features
        if z.shape[-1] < want:
            z = nn.functional.pad(z, (0, want - z.shape[-1]))
        return z[:, :want]

    enc = _distill(enc, teach_encode, sample_strands, steps, batch, label="encoder")
    prior = {"encoder": enc, "decoder": dec}

    # ---- denoiser: optional, distilled over random latent images ----
    if diffusion_ckpt:
        den_ckpt = torch.load(diffusion_ckpt, map_location="cpu", weights_only=False)
        model_t = den_ckpt["model_ema"] if "model_ema" in den_ckpt else den_ckpt
        model_t = model_t.eval().to(device)
        den = Denoiser(DiffusionConfig(input_channels=GEOMETRY_DIM)).init_weights(
            torch.Generator().manual_seed(2)).to(device)

        def teach_denoise(xin):
            x = xin[..., :-1].permute(0, 3, 1, 2)
            out = model_t(x, xin[:, 0, 0, -1])
            return out.permute(0, 2, 3, 1)

        def sample_noisy(rng, n):
            x = rng.normal(size=(n, 32, 32, GEOMETRY_DIM)).astype(np.float32)
            sigma = np.exp(rng.normal(-1.2, 1.2, size=n)).astype(np.float32)
            return t(np.concatenate(
                [x, np.broadcast_to(sigma[:, None, None, None], (n, 32, 32, 1))], axis=-1))

        prior["denoiser"] = _distill(_Denoise(den), teach_denoise, sample_noisy, steps,
                                     max(8, batch // 64), label="denoiser").den

    save_prior(out, prior)
    print(f"wrote {out}")
    return prior


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("convert_neuralhaircut_ckpt")
    ap.add_argument("--selftest", action="store_true",
                    help="tool check without upstream files")
    ap.add_argument("--neuralhaircut_dir", default="",
                    help="path to the NeuralHaircut clone (for src.hair_networks)")
    ap.add_argument("--strand_ckpt", default="")
    ap.add_argument("--diffusion_ckpt", default="",
                    help="optional k-diffusion denoiser checkpoint")
    ap.add_argument("--out", default="")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--strand_length", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest(args.device)
    missing = [f"--{k}" for k in ("neuralhaircut_dir", "strand_ckpt", "out")
               if not getattr(args, k)]
    if missing:
        ap.error(f"converting needs {', '.join(missing)}")
    convert(args.neuralhaircut_dir, args.strand_ckpt, args.out, args.steps, args.batch,
            args.strand_length, args.diffusion_ckpt, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
