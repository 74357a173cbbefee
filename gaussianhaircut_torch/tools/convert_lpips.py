"""Converter: torchvision VGG16 + LPIPS(vgg) heads -> lpips_vgg.npz (port of
``tools/convert_lpips.py``; the same npz schema, fixtures and checks).

The reference computes LPIPS(vgg) with torchvision-pretrained weights
(src/metrics.py:71-78, src/lpipsPyTorch/).  This tool reads the two upstream
files as plain tensors, so neither torchvision nor the ``lpips`` package is
needed: ``--vgg16`` names torchvision's ``vgg16-397923af.pth`` (the
IMAGENET1K_V1 file) and ``--lpips_heads`` the LPIPS v0.1 ``vgg.pth``.  The
npz is what ``gaussianhaircut_torch.ops.lpips.LPIPS`` and the JAX package's
LPIPS load (keys ``conv{i}_w`` / ``conv{i}_b`` in HWIO, ``lin{k}_w``,
``kind``).

Traceability:
- torchvision's file name embeds the first 8 hex digits of its sha256
  (``vgg16-397923af.pth``); when the ``--vgg16`` file is so named, the tool
  checks the digest against it;
- the sha256 of each file read is stored in the npz
  (``source_sha256_vgg16``, ``source_sha256_lpips_vgg``);
- the converted metric's distances on three fixed seeded tensors are stored
  in the npz (``fixture_d_ab`` / ``fixture_d_ac``), and ``--verify path.npz``
  recomputes them.

``--selftest`` needs no upstream file: it writes the deterministic untrained
backbone through the same schema, reloads it and holds the fixture
distances against the constants recorded by the JAX tool.

The fixtures are computed in full float32 (TF32 off), on CUDA unless
``--device cpu`` is given.

    python3 -m gaussianhaircut_torch.tools.convert_lpips --vgg16 vgg16-397923af.pth \\
        --lpips_heads vgg.pth --out weights/lpips_vgg.npz
"""
from __future__ import annotations

import argparse
import hashlib
import os
import re
import tempfile

import numpy as np
import torch

from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.ops.lpips import LPIPS, convert_torch_weights, synthesize_weights

# the fixture tensors' seed and the untrained backbone's distances, as
# recorded in the JAX tool (seed-0 synthesize_weights)
_FIX_SEED = 42
_FIX_D_AB = 0.00078704854240641
_FIX_D_AC = 0.009404431097209454
# conv-backend variance: the recorded values hold across devices to ~1e-3
_RTOL = 3e-3


def _fixture_tensors():
    rng = np.random.default_rng(_FIX_SEED)
    a = rng.uniform(size=(3, 64, 64)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape).astype(np.float32), 0, 1)
    c = rng.uniform(size=(3, 64, 64)).astype(np.float32)
    return a, b, c


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _eval_fixtures(weights: dict, device=None) -> tuple[float, float, float]:
    """d(a, a), d(a, b), d(a, c) of the fixture tensors, in float32."""
    lp = LPIPS(weights=weights, device=resolve_device(device))
    a, b, c = _fixture_tensors()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return float(lp(a, a)), float(lp(a, b)), float(lp(a, c))


def convert(vgg16: str, lpips_heads: str, out_path: str, device=None) -> dict:
    """Convert, record the sources' digests and the fixture distances, write
    ``out_path``; returns the blob."""
    blob = convert_torch_weights(vgg16, lpips_heads)
    digest = _sha256(vgg16)
    m = re.fullmatch(r"vgg16-([0-9a-f]{8,})\.pth", os.path.basename(vgg16))
    if m and not digest.startswith(m.group(1)):
        raise ValueError(f"{vgg16}: sha256 {digest[:8]} does not match the "
                         f"prefix {m.group(1)} in its name")
    blob["source_sha256_vgg16"] = np.asarray(digest)
    blob["source_sha256_lpips_vgg"] = np.asarray(_sha256(lpips_heads))
    d_aa, d_ab, d_ac = _eval_fixtures(blob, device)
    blob["fixture_d_ab"] = np.asarray(d_ab)
    blob["fixture_d_ac"] = np.asarray(d_ac)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **blob)
    print(f"wrote {out_path}: d(a,a)={d_aa:.2e} d(a,b)={d_ab:.6f} "
          f"d(a,c)={d_ac:.6f} (recorded into the npz)")
    return blob


def verify(path: str, device=None) -> int:
    """Recompute the fixture distances against those recorded in the npz."""
    with np.load(path) as z:
        d = dict(z)
    d_aa, d_ab, d_ac = _eval_fixtures(d, device)
    ok = True
    for name, got, want in (("d_ab", d_ab, d.get("fixture_d_ab")),
                            ("d_ac", d_ac, d.get("fixture_d_ac"))):
        if want is None:
            print(f"[warn] {path} has no recorded fixture {name}")
            continue
        want = float(want)
        if not np.isclose(got, want, rtol=_RTOL, atol=1e-7):
            print(f"FAIL {name}: {got} != recorded {want}")
            ok = False
    if abs(d_aa) > 1e-9:
        print(f"FAIL d(a,a) = {d_aa} != 0")
        ok = False
    print("verify:", "OK" if ok else "FAILED", f"(kind={d.get('kind')})")
    return 0 if ok else 1


def selftest(device=None) -> int:
    """No upstream file: the untrained backbone -> npz schema -> reload ->
    the fixture constants recorded in the JAX tool."""
    blob = synthesize_weights()
    d_aa0, d_ab0, d_ac0 = _eval_fixtures(blob, device)
    blob["fixture_d_ab"] = np.asarray(d_ab0)
    blob["fixture_d_ac"] = np.asarray(d_ac0)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "lpips_selftest.npz")
        np.savez(path, **blob)
        rc = verify(path, device)
    if not (np.isclose(d_ab0, _FIX_D_AB, rtol=_RTOL) and np.isclose(d_ac0, _FIX_D_AC, rtol=_RTOL)
            and d_ab0 < d_ac0):
        print(f"FAIL selftest constants: d_ab={d_ab0} (want {_FIX_D_AB}), "
              f"d_ac={d_ac0} (want {_FIX_D_AC})")
        return 1
    print("selftest: OK (schema roundtrip + recorded constants)")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("convert_lpips")
    ap.add_argument("--out", default="weights/lpips_vgg.npz")
    ap.add_argument("--vgg16", default="",
                    help="torchvision's VGG16 IMAGENET1K_V1 state dict (vgg16-397923af.pth)")
    ap.add_argument("--lpips_heads", default="",
                    help="the LPIPS v0.1 'vgg' linear heads (lpips/weights/v0.1/vgg.pth)")
    ap.add_argument("--selftest", action="store_true",
                    help="schema and topology check without upstream files")
    ap.add_argument("--verify", default="",
                    help="re-check a converted npz against its recorded fixture outputs")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.selftest:
        return selftest(device)
    if args.verify:
        return verify(args.verify, device)
    if not (args.vgg16 and args.lpips_heads):
        ap.error("converting needs --vgg16 and --lpips_heads")
    convert(args.vgg16, args.lpips_heads, args.out, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
