"""Converter: distill hyperIQA into the small ``CnnScorer`` convnet (port of
``tools/convert_hyperiqa.py``; the same flags and npz schema).

The reference's frame selection scores with hyperIQA (ResNet-50 and a
hypernetwork, cloned at install time;
src/preprocessing/preprocess_raw_images.py:70-122).  Its topology is not
re-derived weight for weight: like ``convert_neuralhaircut_ckpt``, this tool
runs hyperIQA over a frame corpus and fits ``preprocessing/iqa.CnnScorer``'s
convnet to its scores.  The npz (``conv{i}_w`` HWIO, ``conv{i}_b``,
``head_w``, ``head_b``, ``kind = "distilled-hyperiqa"``) is what the
``CnnScorer`` of either package loads.

Inputs: ``--hyperiqa_dir`` is the hyperIQA clone (its ``models.py`` is
imported), ``--hyperiqa_ckpt`` the KonIQ state dict under it, and
``--frames_dir`` a directory of PNG frames (other files are skipped; the
port reads images as PNG).  Frames are resized to 224x224 with the port's
bilinear resize (``iqa._resize_bilinear``, OpenCV's INTER_LINEAR within one
level) and blurred for the augmentation by ``gaussian_blur_like_cv2``.
hyperIQA's ``HyperNet`` builds its ResNet-50 backbone with ImageNet weights
through ``torch.utils.model_zoo``, so the conversion machine needs
``resnet50-19c8e357.pth`` in torch's hub cache (``$TORCH_HOME/hub/checkpoints``)
or network access.  Runs on CUDA unless ``--device cpu`` is given.

    python3 -m gaussianhaircut_torch.tools.convert_hyperiqa --hyperiqa_dir ext/hyperIQA \\
        --frames_dir $DATA/images --out weights/hyperiqa_distilled.npz [--steps 3000]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.preprocessing.iqa import CnnScorer, _resize_bilinear
from gaussianhaircut_torch.utils.image import read_png

# cv2.getGaussianKernel's fixed kernels for odd sizes up to 9 when sigma <= 0
_CV_SMALL_GAUSSIAN = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
    9: (0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375, 0.19921875, 0.1171875,
        0.05078125, 0.015625),
}


def _cv_gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(k, sigma, CV_32F)``: the fixed table for k <=
    9 and sigma <= 0, else exp(-x^2 / 2 sigma^2) with sigma defaulting to
    0.3 ((k - 1) / 2 - 1) + 0.8; float32 taps normalised in float64."""
    if sigma <= 0 and k in _CV_SMALL_GAUSSIAN:
        taps = np.asarray(_CV_SMALL_GAUSSIAN[k], np.float32)
    else:
        s = sigma if sigma > 0 else 0.3 * ((k - 1) * 0.5 - 1) + 0.8
        x = np.arange(k) - (k - 1) * 0.5
        taps = np.exp(-0.5 / (s * s) * x * x).astype(np.float32)
    return (taps.astype(np.float64) * (1.0 / taps.astype(np.float64).sum())).astype(np.float32)


def gaussian_blur_like_cv2(x: np.ndarray, k: int, sigma: float = 0.0) -> np.ndarray:
    """``cv2.GaussianBlur(x, (k, k), sigma)`` of a float32 [H, W] or [H, W, C]
    image: OpenCV's separable kernel, rows then columns, BORDER_REFLECT_101."""
    x = np.asarray(x, np.float32)
    if k == 1:
        return x.copy()
    w = _cv_gaussian_kernel(k, sigma).astype(np.float64)
    r = k // 2
    pad = ((0, 0), (r, r)) + ((0, 0),) * (x.ndim - 2)
    xp = np.pad(x.astype(np.float64), pad, mode="reflect")
    rows = sum(w[i] * xp[:, i:i + x.shape[1]] for i in range(k)).astype(np.float32)
    pad = ((r, r), (0, 0)) + ((0, 0),) * (x.ndim - 2)
    xp = np.pad(rows.astype(np.float64), pad, mode="reflect")
    return sum(w[i] * xp[i:i + x.shape[0]] for i in range(k)).astype(np.float32)


def init_params(generator: torch.Generator, channels=(16, 32, 64, 128)) -> dict:
    """He-normal 3x3 convolutions (HWIO), zero biases, a head of 0.01 N(0, 1)."""
    params = {}
    cin = 3
    for i, cout in enumerate(channels):
        w = torch.randn((3, 3, cin, cout), generator=generator) * np.sqrt(2.0 / (9 * cin))
        params[f"conv{i}_w"] = w.numpy().astype(np.float32)
        params[f"conv{i}_b"] = np.zeros(cout, np.float32)
        cin = cout
    params["head_w"] = (torch.randn((cin,), generator=generator) * 0.01).numpy()
    params["head_b"] = np.zeros((), np.float32)
    return params


def scorer_params(scorer: CnnScorer) -> dict:
    """The npz arrays of a ``CnnScorer`` (convolutions back to HWIO)."""
    out = {}
    for i, conv in enumerate(scorer.convs):
        out[f"conv{i}_w"] = conv.weight.detach().permute(2, 3, 1, 0).cpu().numpy().copy()
        out[f"conv{i}_b"] = conv.bias.detach().cpu().numpy().copy()
    out["head_w"] = scorer.head_w.detach().cpu().numpy().copy()
    out["head_b"] = scorer.head_b.detach().cpu().numpy().copy()
    return out


def distill(imgs: np.ndarray, teacher_score, *, steps: int, batch: int, seed: int = 0,
            channels=(16, 32, 64, 128), augment=None, log_every: int = 200,
            device=None) -> dict:
    """Fit ``CnnScorer``'s convnet to ``teacher_score`` on ``imgs`` by MSE
    with Adam (lr 1e-3); returns the npz arrays.

    ``imgs``: [N, H, W, 3] float32 in [0, 1]; ``teacher_score``: [B, H, W, 3]
    numpy -> [B] scores; ``augment``: an optional (x, numpy rng) -> x applied
    every other step, so that the student learns the quality axis rather
    than the content.  The batches are drawn from ``default_rng(seed)``, the
    initial weights from a ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    student = CnnScorer(weights=init_params(torch.Generator().manual_seed(seed), channels),
                        device=device).requires_grad_(True)
    opt = torch.optim.Adam(student.parameters(), lr=1e-3)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        idx = rng.integers(0, len(imgs), batch)
        x = imgs[idx]
        if augment is not None and i % 2:
            x = augment(x, rng)
        y = torch.as_tensor(np.asarray(teacher_score(x), np.float32).reshape(-1), device=device)
        loss = torch.mean((student(torch.as_tensor(x, device=device)) - y) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and i % log_every == 0:
            print(f"step {i}: mse={loss.item():.4f}", flush=True)
    return scorer_params(student)


def save_npz(params: dict, out_path: str) -> None:
    blob = {k: np.asarray(v) for k, v in params.items()}
    blob["kind"] = np.asarray("distilled-hyperiqa")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **blob)


def _lap_var(batch: np.ndarray) -> np.ndarray:
    """The selftest's teacher: 100 x the variance of the 4-neighbour
    Laplacian of the grey image (the sharpness axis hyperIQA scores)."""
    g = batch.mean(-1)
    lap = (-4 * g[:, 1:-1, 1:-1] + g[:, :-2, 1:-1] + g[:, 2:, 1:-1]
           + g[:, 1:-1, :-2] + g[:, 1:-1, 2:])
    return 100.0 * lap.reshape(len(batch), -1).var(axis=1)


def blur_corpus(seed: int = 11, n_tex: int = 6, sigmas=(0.0, 0.7, 1.4, 2.2, 3.0)) -> np.ndarray:
    """The selftest's corpus: ``n_tex`` uniform 64x64 textures, each blurred
    at ``sigmas`` (k = 2 int(3 sigma) + 1), texture-major."""
    rng = np.random.default_rng(seed)
    bases = [rng.uniform(0, 1, (64, 64, 3)).astype(np.float32) for _ in range(n_tex)]
    return np.stack([b if s <= 0 else gaussian_blur_like_cv2(b, 2 * int(3 * s) + 1, s)
                     for b in bases for s in sigmas])


def selftest(device=None) -> int:
    """No upstream file: the distillation fits the Laplacian-variance
    teacher on a blur corpus, ranks held-out textures (Spearman > 0.7, the
    sharpest above the blurriest) and round-trips through ``CnnScorer``."""
    device = resolve_device(device)
    n_sigma = 5
    imgs = blur_corpus()
    train, held = imgs[:4 * n_sigma], imgs[4 * n_sigma:]
    params = distill(train, _lap_var, steps=260, batch=8, seed=0, channels=(8, 16, 32),
                     log_every=0, device=device)
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "iqa.npz")
        save_npz(params, out)
        scorer = CnnScorer(out, device)
        with torch.no_grad():
            s = scorer(torch.as_tensor(held, device=device)).cpu().numpy()
    teach = _lap_var(held)
    r_s = np.argsort(np.argsort(s)).astype(np.float64)
    r_t = np.argsort(np.argsort(teach)).astype(np.float64)
    rho = float(np.corrcoef(r_s, r_t)[0, 1])
    ok = rho > 0.7 and all(s[t * n_sigma] > s[t * n_sigma + n_sigma - 1] for t in range(2))
    print(f"selftest: rho={rho:.3f} kind={scorer.kind} ->", "OK" if ok else "FAILED")
    return 0 if ok else 1


def load_frames(frames_dir: str, size: int = 224) -> np.ndarray:
    """The PNG frames of ``frames_dir`` (sorted; other files skipped) as RGB,
    resized to size x size -> float32 [N, size, size, 3] in [0, 1]."""
    imgs = []
    for name in sorted(os.listdir(frames_dir)):
        if not name.lower().endswith(".png"):
            continue
        img = read_png(os.path.join(frames_dir, name))
        if img.ndim == 2:
            img = img[..., None]
        img = np.repeat(img[..., :1], 3, axis=-1) if img.shape[-1] <= 2 else img[..., :3]
        imgs.append(_resize_bilinear(img, size, size).astype(np.float32) / 255.0)
    if not imgs:
        raise FileNotFoundError(f"no PNG frame in {frames_dir}")
    return np.stack(imgs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("convert_hyperiqa")
    ap.add_argument("--hyperiqa_dir", default="")
    ap.add_argument("--hyperiqa_ckpt", default="pretrained/koniq_pretrained.pkl")
    ap.add_argument("--frames_dir", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--selftest", action="store_true", help="tool check without upstream files")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest(args.device)
    missing = [f"--{k}" for k in ("hyperiqa_dir", "frames_dir", "out") if not getattr(args, k)]
    if missing:
        ap.error(f"converting needs {', '.join(missing)}")
    device = resolve_device(args.device)

    sys.path.insert(0, args.hyperiqa_dir)
    import models as hyperiqa_models  # upstream hyperIQA repo

    model_hyper = hyperiqa_models.HyperNet(16, 112, 224, 112, 56, 28, 14, 7).eval()
    model_hyper.load_state_dict(torch.load(
        os.path.join(args.hyperiqa_dir, args.hyperiqa_ckpt), map_location="cpu",
        weights_only=True))
    model_hyper.to(device)
    mean = torch.tensor([0.485, 0.456, 0.406], device=device)[None, :, None, None]
    std = torch.tensor([0.229, 0.224, 0.225], device=device)[None, :, None, None]

    @torch.no_grad()
    def teacher_score(batch_rgb01):   # [N, 224, 224, 3] float
        x = torch.as_tensor(batch_rgb01.transpose(0, 3, 1, 2), device=device)
        paras = model_hyper((x - mean) / std)
        model_target = hyperiqa_models.TargetNet(paras).eval()
        return model_target(paras["target_in_vec"]).cpu().numpy()

    imgs = load_frames(args.frames_dir)

    def augment_blur(x, rng):
        k = int(rng.integers(1, 4)) * 2 + 1
        return np.stack([gaussian_blur_like_cv2(v, k) for v in x])

    params = distill(imgs, teacher_score, steps=args.steps, batch=args.batch,
                     augment=augment_blur, device=device)
    save_npz(params, args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
