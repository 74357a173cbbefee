"""Offline metrics CLI: SSIM, PSNR and LPIPS over exported render
directories (port of ``gaussianhaircut_tpu/cli/metrics.py``; reference
src/metrics.py:36-93).

    python3 -m gaussianhaircut_torch.cli.metrics -m MODEL [MODEL ...] [--lpips_weights NPZ]

Walks ``<model>/test/<method>/{renders,gt}`` and writes ``results.json`` and
``per_view.json`` with the JAX package's keys.  Without calibrated LPIPS
weights the metric is the untrained seeded backbone, keyed
``LPIPS[untrained-seeded]``, never ``LPIPS``.  Runs on the GPU; ``--device
cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.ops.losses import psnr
from gaussianhaircut_torch.ops.lpips import lpips_or_none
from gaussianhaircut_torch.ops.ssim import ssim
from gaussianhaircut_torch.utils.image import read_png


def load_rgb(path: str, device) -> torch.Tensor:
    """PIL's ``Image.open(path).convert("RGB")`` of an 8-bit PNG (gray
    replicated, alpha dropped) as [3, H, W] float32 in [0, 1]."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    img = np.repeat(img[..., :1], 3, -1) if img.shape[-1] in (1, 2) else img[..., :3]
    return torch.as_tensor(img.astype(np.float32).transpose(2, 0, 1) / 255.0, device=device)


def evaluate_dir(renders_dir: str, gt_dir: str, lpips_weights=None,
                 allow_untrained_lpips: bool = True, device=None):
    """(means, per_view) over the PNGs of ``renders_dir`` and their
    namesakes in ``gt_dir``."""
    device = resolve_device(device)
    lp = lpips_or_none(lpips_weights, allow_untrained=allow_untrained_lpips, device=device)
    # an uncalibrated LPIPS never prints under the bare "LPIPS" name: the key
    # carries the backbone kind unless the weights are the calibrated ones
    lpips_key = None
    if lp is not None:
        lpips_key = "LPIPS" if lp.kind == "pretrained" else f"LPIPS[{lp.kind}]"
        if lp.kind != "pretrained":
            print(f"  [metrics] LPIPS backbone is '{lp.kind}' (no pretrained weights "
                  "found): the values are not comparable to published LPIPS numbers "
                  f"and are keyed as '{lpips_key}' in results.json")
    per_view = {"SSIM": {}, "PSNR": {}}
    if lpips_key is not None:
        per_view[lpips_key] = {}
    with torch.no_grad():
        for name in sorted(os.listdir(renders_dir)):
            r = load_rgb(os.path.join(renders_dir, name), device)
            g = load_rgb(os.path.join(gt_dir, name), device)
            per_view["SSIM"][name] = float(ssim(r, g))
            per_view["PSNR"][name] = float(psnr(r, g))
            if lp is not None:
                per_view[lpips_key][name] = float(lp(r, g))
    means = {k: float(np.mean(list(v.values()))) for k, v in per_view.items() if v}
    if lp is not None:
        means["LPIPS_kind"] = lp.kind
    return means, per_view


def evaluate(model_paths, lpips_weights=None, device=None) -> dict:
    """Every ``<model>/test/<method>`` with renders and gt; writes
    ``results.json`` and ``per_view.json`` under each model path."""
    device = resolve_device(device)
    full, per = {}, {}
    for model_path in model_paths:
        full[model_path] = {}
        per[model_path] = {}
        test_dir = os.path.join(model_path, "test")
        if not os.path.isdir(test_dir):
            print(f"no test dir under {model_path}")
            continue
        for method in sorted(os.listdir(test_dir)):
            renders = os.path.join(test_dir, method, "renders")
            gt = os.path.join(test_dir, method, "gt")
            if not (os.path.isdir(renders) and os.path.isdir(gt)):
                continue
            means, views = evaluate_dir(renders, gt, lpips_weights, device=device)
            full[model_path][method] = means
            per[model_path][method] = views
            print(f"  {method}: " + "  ".join(
                f"{k} {v:.7f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in means.items()))
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full[model_path], f, indent=True)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per[model_path], f, indent=True)
    return full


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("metrics")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--lpips_weights", default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda")
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, args.lpips_weights, args.device)


if __name__ == "__main__":
    main()
