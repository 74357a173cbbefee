"""LPIPS perceptual distance (port of ``gaussianhaircut_tpu/ops/lpips.py``;
reference src/lpipsPyTorch/).

VGG16 conv features (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3),
unit-normalised per channel, squared differences weighted by the LPIPS
linear heads, averaged over space.  Two quirks of the reference, kept:
- inputs in **[0, 1]** go straight into the z-score layer, with no [-1, 1]
  rescale (src/lpipsPyTorch/modules/networks.py:49-51);
- the channel normalisation is x / (||x|| + 1e-10), the epsilon outside the
  square root (modules/utils.py:6-8).

Weights come from an npz (keys ``conv{i}_w`` [kh, kw, cin, cout] (HWIO,
mapped to OIHW here), ``conv{i}_b``, ``lin{k}_w`` [c], ``kind``), as
``tools/convert_lpips.py`` writes it from torchvision's VGG16 file and the
LPIPS heads file (``convert_torch_weights``).  Without
one, ``lpips_or_none(allow_untrained=True)`` gives the deterministic
He-initialised backbone of ``synthesize_weights`` (numpy ``default_rng``,
bit-identical to the JAX package's), labelled ``kind = "untrained-seeded"``
so that its numbers are never reported as the calibrated metric.  Runs on
CUDA unless given ``device="cpu"``.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from gaussianhaircut_torch.device import resolve_device

# VGG16: (out_channels, layers) per block; LPIPS taps the last ReLU of each
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_DEFAULT_WEIGHTS = os.environ.get(
    "GHT_LPIPS_WEIGHTS",
    os.path.join(os.path.dirname(__file__), "..", "..", "weights", "lpips_vgg.npz"))


# torchvision's VGG16 ``features`` indices of the thirteen convolutions
_VGG_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def convert_torch_weights(vgg16_path: str, lpips_heads_path: str) -> dict:
    """torchvision's VGG16 state dict (``vgg16-397923af.pth``: keys
    ``features.{i}.weight`` [cout, cin, 3, 3] and ``.bias``) and the LPIPS
    v0.1 'vgg' heads (``vgg.pth``: ``lin{k}.model.1.weight`` [1, C, 1, 1])
    -> the npz blob (``conv{i}_w`` HWIO, ``conv{i}_b``, ``lin{k}_w`` [C],
    ``kind = "pretrained"``).  Both files are read as plain tensors
    (``weights_only``): neither torchvision nor the ``lpips`` package is
    needed."""
    vgg = torch.load(vgg16_path, map_location="cpu", weights_only=True)
    heads = torch.load(lpips_heads_path, map_location="cpu", weights_only=True)
    np32 = lambda t: t.detach().to(torch.float32).numpy()
    blob = {}
    for i, idx in enumerate(_VGG_CONV_INDICES):
        blob[f"conv{i}_w"] = np32(vgg[f"features.{idx}.weight"]).transpose(2, 3, 1, 0).copy()
        blob[f"conv{i}_b"] = np32(vgg[f"features.{idx}.bias"])
    for k in range(len(_VGG_BLOCKS)):
        blob[f"lin{k}_w"] = np32(heads[f"lin{k}.model.1.weight"]).reshape(-1)
    blob["kind"] = np.asarray("pretrained")
    return blob


def synthesize_weights(seed: int = 0) -> dict:
    """Deterministic He-initialised VGG16 and uniform linear heads: the
    untrained stand-in, NOT the calibrated LPIPS (kind
    ``untrained-seeded``)."""
    rng = np.random.default_rng(seed)
    blob = {}
    cin = 3
    i = 0
    for cout, layers in _VGG_BLOCKS:
        for _ in range(layers):
            fan_in = 3 * 3 * cin
            blob[f"conv{i}_w"] = rng.normal(
                0.0, math.sqrt(2.0 / fan_in), size=(3, 3, cin, cout)).astype(np.float32)
            blob[f"conv{i}_b"] = np.zeros(cout, np.float32)
            cin = cout
            i += 1
    for k, (cout, _) in enumerate(_VGG_BLOCKS):
        blob[f"lin{k}_w"] = rng.uniform(0, 2.0 / cout, cout).astype(np.float32)
    blob["kind"] = np.asarray("untrained-seeded")
    return blob


class LPIPS:
    """The metric on a device: ``lp(a, b)`` for [3, H, W] (-> scalar) or
    [N, 3, H, W] (-> [N]) tensors or arrays in [0, 1]."""

    def __init__(self, weights_path: str | None = None, weights: dict | None = None,
                 device=None):
        self.device = resolve_device(device)
        if weights is None:
            path = weights_path or _DEFAULT_WEIGHTS
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"LPIPS weights not found at {path}; write them with python3 -m "
                    "gaussianhaircut_torch.tools.convert_lpips from torchvision's VGG16 "
                    "and the LPIPS 'vgg' heads, or set GHT_LPIPS_WEIGHTS")
            with np.load(path) as z:
                weights = dict(z)
        d = weights
        self.kind = str(d.get("kind", "pretrained"))
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self.conv_w, self.conv_b = [], []
        i = 0
        while f"conv{i}_w" in d:
            self.conv_w.append(t(np.asarray(d[f"conv{i}_w"]).transpose(3, 2, 0, 1).copy()))
            self.conv_b.append(t(d[f"conv{i}_b"]))
            i += 1
        self.lin_w = [t(d[f"lin{k}_w"]) for k in range(len(_VGG_BLOCKS))]
        self.shift = t(_SHIFT)[:, None, None]
        self.scale = t(_SCALE)[:, None, None]

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x [N, 3, H, W] in [0, 1] -> the unit-normalised ReLU taps."""
        x = (x - self.shift) / self.scale
        feats = []
        ci = 0
        for bi, (_, layers) in enumerate(_VGG_BLOCKS):
            for _ in range(layers):
                x = F.relu(F.conv2d(x, self.conv_w[ci], self.conv_b[ci], padding=1))
                ci += 1
            norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
            feats.append(x / (norm + 1e-10))
            if bi < len(_VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2)
        return feats

    @torch.no_grad()
    def distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for k, (na, nb) in enumerate(zip(self.features(a), self.features(b))):
            d = (na - nb) ** 2
            total = total + torch.mean(torch.sum(d * self.lin_w[k][None, :, None, None],
                                                 dim=1), dim=(1, 2))
        return total

    def __call__(self, a, b) -> torch.Tensor:
        a = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
        if a.ndim == 3:
            return self.distance(a[None], b[None])[0]
        return self.distance(a, b)


def lpips_or_none(weights_path: str | None = None, allow_untrained: bool = False,
                  device=None):
    """LPIPS from ``weights_path`` (or the default location); when the
    weights are missing, None, or with ``allow_untrained=True`` the metric
    on the untrained seeded backbone (check ``.kind`` before reporting)."""
    try:
        return LPIPS(weights_path, device=device)
    except FileNotFoundError:
        if allow_untrained:
            return LPIPS(weights=synthesize_weights(), device=device)
        return None
