"""Fabricated upstream inputs of the three pretrained-weight converters, in
the upstream layouts (no real checkpoint is in the repository):

- torchvision's VGG16 state dict and the LPIPS v0.1 'vgg' heads, written
  from an LPIPS weight blob (``write_lpips_files``);
- a NeuralHaircut mini-tree with the strand-VAE twin of
  ``tests/test_prior_convert_e2e.py``, its ``strand_ckpt.pth`` and a pickled
  k-diffusion-shaped denoiser (``write_neuralhaircut_tree``);
- a hyperIQA mini-tree whose ``models.py`` has ``HyperNet`` / ``TargetNet``
  twins, with its KonIQ state dict (``write_hyperiqa_tree``).

Imports torch and numpy (and the twin's source from
``test_prior_convert_e2e``), nothing of JAX, so that the CPU tests, the
isolation test and ``chip_smoke.py`` share it.
"""
import contextlib
import os
import sys
import textwrap

import numpy as np
import torch

from tests.test_prior_convert_e2e import UPSTREAM_TWIN

# torchvision's VGG16 ``features`` indices of the thirteen convolutions
VGG_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

TWIN_DENOISER = textwrap.dedent('''
    """A k-diffusion-shaped twin: model(x [N, C, H, W], sigma [N])."""
    import torch
    import torch.nn as nn


    class TwinDenoiser(nn.Module):
        def __init__(self, channels=64):
            super().__init__()
            self.conv = nn.Conv2d(channels, channels, 3, padding=1)

        def forward(self, x, sigma):
            c = (1.0 / (1.0 + sigma ** 2))[:, None, None, None]
            return c * x + 0.1 * self.conv(x) * torch.log(sigma)[:, None, None, None]
''')

TWIN_HYPERIQA = textwrap.dedent('''
    """A hyperIQA-shaped twin: HyperNet(...) -> paras, TargetNet(paras)."""
    import torch
    import torch.nn as nn


    class HyperNet(nn.Module):
        def __init__(self, lda_out, hyper_in, target_in, f1, f2, f3, f4, feature_size):
            super().__init__()
            self.conv = nn.Conv2d(3, 8, 3, stride=4)
            self.fc = nn.Linear(8, 8)

        def forward(self, img):
            h = torch.relu(self.conv(img)).mean(dim=(2, 3))
            return {"target_in_vec": h, "w": self.fc(h)}


    class TargetNet(nn.Module):
        def __init__(self, paras):
            super().__init__()
            self.w = paras["w"]

        def forward(self, x):
            return (x * self.w).sum(-1)
''')


def write_lpips_files(root: str, blob: dict, classifier: bool = False) -> tuple[str, str]:
    """torchvision's ``vgg16.pth`` (features in OIHW; with ``classifier`` the
    full file's three dense layers, zeros, which the converter skips) and
    LPIPS's ``vgg.pth`` from ``blob`` -> their paths."""
    os.makedirs(root, exist_ok=True)
    sd = {}
    for i, idx in enumerate(VGG_CONV_INDICES):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(blob[f"conv{i}_w"].transpose(3, 2, 0, 1)))
        sd[f"features.{idx}.bias"] = torch.from_numpy(blob[f"conv{i}_b"])
    dense = ((0, 4096, 25088), (3, 4096, 4096), (6, 1000, 4096)) if classifier else ()
    for idx, n_out, n_in in dense:
        sd[f"classifier.{idx}.weight"] = torch.zeros(n_out, n_in)
        sd[f"classifier.{idx}.bias"] = torch.zeros(n_out)
    heads = {f"lin{k}.model.1.weight": torch.from_numpy(blob[f"lin{k}_w"]).reshape(1, -1, 1, 1)
             for k in range(5)}
    vgg, lin = os.path.join(root, "vgg16.pth"), os.path.join(root, "vgg.pth")
    torch.save(sd, vgg)
    torch.save(heads, lin)
    return vgg, lin


@contextlib.contextmanager
def _upstream_on_path(tree: str):
    """Import from ``tree`` as the converters will; afterwards sys.path and
    sys.modules are as they were."""
    path, mods = list(sys.path), set(sys.modules)
    sys.path.insert(0, tree)
    try:
        yield
    finally:
        sys.path[:] = path
        for m in set(sys.modules) - mods:
            del sys.modules[m]


def write_neuralhaircut_tree(root: str, seed: int = 0) -> tuple[str, str, str]:
    """-> (the NeuralHaircut tree, ``strand_ckpt.pth``, a denoiser checkpoint
    ``{"model_ema": TwinDenoiser}``, a pickled module) under ``root``."""
    nh = os.path.join(root, "NeuralHaircut")
    pkg = os.path.join(nh, "src", "hair_networks")
    os.makedirs(pkg, exist_ok=True)
    for path, text in ((os.path.join(nh, "src", "__init__.py"), ""),
                       (os.path.join(pkg, "__init__.py"), ""),
                       (os.path.join(pkg, "strand_prior.py"), UPSTREAM_TWIN),
                       (os.path.join(pkg, "twin_denoiser.py"), TWIN_DENOISER)):
        with open(path, "w") as f:
            f.write(text)
    ckpt, den = os.path.join(root, "strand_ckpt.pth"), os.path.join(root, "denoiser.pth")
    torch.manual_seed(seed)
    with _upstream_on_path(nh):
        from src.hair_networks.strand_prior import Decoder, Encoder
        from src.hair_networks.twin_denoiser import TwinDenoiser
        torch.save({"encoder": Encoder(None).state_dict(),
                    "decoder": Decoder(None).state_dict()}, ckpt)
        torch.save({"model_ema": TwinDenoiser()}, den)
    return nh, ckpt, den


def write_hyperiqa_tree(root: str, seed: int = 0) -> str:
    """The hyperIQA tree (``models.py`` and
    ``pretrained/koniq_pretrained.pkl``) under ``root`` -> its path."""
    hq = os.path.join(root, "hyperIQA")
    os.makedirs(os.path.join(hq, "pretrained"), exist_ok=True)
    with open(os.path.join(hq, "models.py"), "w") as f:
        f.write(TWIN_HYPERIQA)
    torch.manual_seed(seed)
    with _upstream_on_path(hq):
        from models import HyperNet
        torch.save(HyperNet(16, 112, 224, 112, 56, 28, 14, 7).state_dict(),
                   os.path.join(hq, "pretrained", "koniq_pretrained.pkl"))
    return hq
