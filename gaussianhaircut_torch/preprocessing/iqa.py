"""No-reference image-quality scorers for frame selection (port of
``gaussianhaircut_tpu/preprocessing/iqa.py``; the reference scores frames
with hyperIQA, src/preprocessing/preprocess_raw_images.py:70-122).

Tiers, the best available wins (``default_scorer``):

1. ``CnnScorer(weights_path).score``: the small convnet distilled from
   hyperIQA (npz keys ``conv{i}_w`` [3, 3, ci, co], ``conv{i}_b``,
   ``head_w`` [c], ``head_b``), an ``nn.Module`` on a torch device;
2. ``mscn_iqa``: the natural-scene-statistics score, numpy, a copy of the
   JAX package's;
3. ``frames.sharpness_iqa``: the round-2 proxy.

All scorers share the interface ``score = f(img_rgb_uint8) -> float``
(higher is better).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussianhaircut_torch.device import resolve_device


def _gauss7() -> np.ndarray:
    x = np.arange(7) - 3
    g = np.exp(-(x ** 2) / (2 * (7.0 / 6.0) ** 2))
    return (g / g.sum()).astype(np.float32)


def _sep_blur(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'same' blur with edge replication."""
    pad = len(k) // 2
    xp = np.pad(x, ((pad, pad), (0, 0)), mode="edge")
    x = sum(k[i] * xp[i:i + x.shape[0]] for i in range(len(k)))
    xp = np.pad(x, ((0, 0), (pad, pad)), mode="edge")
    return sum(k[i] * xp[:, i:i + x.shape[1]] for i in range(len(k)))


def mscn_iqa(img_rgb: np.ndarray) -> float:
    """Natural-scene-statistics quality score (higher is better): local
    contrast (the MSCN sigma field's mean) minus a robust noise estimate
    (the Laplacian's median absolute value / 0.6745), times the exposure
    spread."""
    img = np.asarray(img_rgb)
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).astype(np.float32)
    if min(gray.shape) < 16:
        return 0.0
    k = _gauss7()
    mu = _sep_blur(gray, k)
    sigma = np.sqrt(np.maximum(_sep_blur(gray * gray, k) - mu * mu, 0.0))
    contrast = float(sigma.mean())

    lap = (gray[1:-1, 1:-1] * 4 - gray[:-2, 1:-1] - gray[2:, 1:-1]
           - gray[1:-1, :-2] - gray[1:-1, 2:])
    noise = float(np.median(np.abs(lap)) / 0.6745)

    spread = float(np.percentile(gray, 95) - np.percentile(gray, 5)) / 255.0
    return max(contrast - 0.2 * noise, 0.0) * (spread + 1e-3)


def _resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """OpenCV's ``cv2.resize(img, (width, height))`` (INTER_LINEAR) of a
    uint8 [H, W(, C)] image: samples at half-pixel centres, clamped at the
    borders, no widening when shrinking; float weights, rounded to 8 bits
    (OpenCV's 11-bit fixed-point weights can differ by one level)."""
    h, w = img.shape[:2]

    def taps(n_in, n_out):
        s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(s).astype(np.int64)
        f = s - i0
        f = np.where(i0 < 0, 0.0, np.where(i0 >= n_in - 1, 0.0, f))
        i0 = np.clip(i0, 0, n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), f

    y0, y1, fy = taps(h, height)
    x0, x1, fx = taps(w, width)
    x = img.astype(np.float64)
    fx = fx.reshape((1, -1) + (1,) * (img.ndim - 2))
    rows = x[:, x0] * (1 - fx) + x[:, x1] * fx
    fy = fy.reshape((-1, 1) + (1,) * (img.ndim - 2))
    out = rows[y0] * (1 - fy) + rows[y1] * fy
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _same_pad(n: int, k: int = 3, stride: int = 2) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: the total split low = total // 2,
    so a stride-2 3x3 conv on an even size pads (0, 1), not (1, 1)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class CnnScorer(nn.Module):
    """Distilled-hyperIQA convnet: stride-2 3x3 convolutions with ReLU,
    global average pooling and a linear head, on a torch device (CUDA
    unless ``device="cpu"``).  The weights come from the npz at
    ``weights_path`` or from ``weights``, a dict of its arrays (the
    converter's student, ``tools/convert_hyperiqa.py``)."""

    def __init__(self, weights_path: str | None = None, device=None, *,
                 weights: dict | None = None):
        super().__init__()
        if weights is None:
            with np.load(weights_path) as z:
                weights = dict(z)
        d = weights
        self.kind = str(d.get("kind", "distilled-hyperiqa"))
        n_conv = len([k for k in d if k.startswith("conv") and k.endswith("_w")])
        self.convs = nn.ModuleList()
        for i in range(n_conv):
            w = np.asarray(d[f"conv{i}_w"], np.float32)          # HWIO
            conv = nn.Conv2d(w.shape[2], w.shape[3], 3, stride=2)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
                conv.bias.copy_(torch.from_numpy(np.asarray(d[f"conv{i}_b"], np.float32)))
            self.convs.append(conv)
        self.head_w = nn.Parameter(torch.from_numpy(np.asarray(d["head_w"], np.float32)))
        self.head_b = nn.Parameter(torch.as_tensor(np.asarray(d["head_b"], np.float32)))
        self.requires_grad_(False)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] in [0, 1] -> [N] scores."""
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            ph, pw = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.relu(conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1]))))
        return x.mean(dim=(2, 3)) @ self.head_w + self.head_b

    def score(self, img_rgb: np.ndarray) -> float:
        """The scorer interface: uint8 [H, W, 3] -> float, through the
        224x224 resize."""
        x = _resize_bilinear(np.asarray(img_rgb), 224, 224).astype(np.float32) / 255.0
        with torch.no_grad():
            return float(self(torch.as_tensor(x, device=self.head_w.device)[None])[0])


_DEFAULT_CNN = os.environ.get(
    "GHT_IQA_WEIGHTS",
    os.path.join(os.path.dirname(__file__), "..", "..", "weights",
                 "hyperiqa_distilled.npz"))


def default_scorer(device=None):
    """Best available scorer: the distilled CNN when its npz exists (on
    ``device``, CUDA by default), else MSCN."""
    if os.path.exists(_DEFAULT_CNN):
        return CnnScorer(_DEFAULT_CNN, device).score
    return mscn_iqa
