"""Face-landmark glue: the reference's ``face_alignment/`` contract
(``lmks_2d.pkl`` / ``lmks_3d.pkl``, dicts keyed by image basename, and
scatter visualisations) from (a) precomputed per-image landmark .npy files,
(b) an external detector command, or (c) a smoke-grade geometric fallback
(port of ``gaussianhaircut_tpu/cli/calc_face_alignment.py``; reference
src/preprocessing/calc_face_alignment.py, which runs the ``face_alignment``
package's 2D and 3D models).  The neural detector stays external; this CLI
owns the files the FLAME fit reads.

Modes:
  --landmarks_dir D : read D/<basename>_2d.npy [68, 2] and, where present,
                      D/<basename>_3d.npy [68, 3] per image;
  --external_cmd C  : run ``C <image> <out_2d.npy> <out_3d.npy>`` per image;
  (neither)         : a canonical 68-point template scaled to a skin-tone
                      bounding box: enough to drive the FLAME-fitting glue
                      on synthetic scenes, NOT a detector.

Two deliberate differences from the JAX tool, which reads and writes
through PIL: images are read with the port's PNG codec (8-bit PNG only; any
other format raises, as ``preprocessing/frames.extract_frames`` raises for
video), and the visualisations are written as ``vis_2d/<basename>.png`` /
``vis_3d/<basename>.png``, not JPEG (no JPEG encoder on the GPU machine).
The pickles, which the FLAME fit reads, are the JAX tool's.

    python3 -m gaussianhaircut_torch.cli.calc_face_alignment --data_path SCENE
        [--image_dir images] [--landmarks_dir D | --external_cmd C] [--no_vis]
"""
from __future__ import annotations

import argparse
import os
import pickle
import subprocess
import tempfile
from glob import glob

import numpy as np

from gaussianhaircut_torch.preprocessing.frames import imread_rgb
from gaussianhaircut_torch.utils.image import write_png

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _template68() -> np.ndarray:
    """A canonical 68-landmark template in a unit face box (x right, y
    down), iBUG-68 order: 17 jaw, 10 brows, 9 nose, 12 eyes, 20 mouth."""
    t = np.linspace(0.0, 1.0, 17)
    jaw = np.stack([t, 0.35 + 0.6 * np.sin(np.pi * t) * 0.9], axis=-1)
    brow_l = np.stack([np.linspace(0.12, 0.42, 5), np.full(5, 0.30)], axis=-1)
    brow_r = np.stack([np.linspace(0.58, 0.88, 5), np.full(5, 0.30)], axis=-1)
    nose_v = np.stack([np.full(4, 0.50), np.linspace(0.38, 0.58, 4)], axis=-1)
    nose_b = np.stack([np.linspace(0.42, 0.58, 5), np.full(5, 0.62)], axis=-1)
    a = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    eye_l = np.stack([0.27 + 0.07 * np.cos(a), 0.40 + 0.03 * np.sin(a)], axis=-1)
    eye_r = np.stack([0.73 + 0.07 * np.cos(a), 0.40 + 0.03 * np.sin(a)], axis=-1)
    am = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    mouth_o = np.stack([0.50 + 0.14 * np.cos(am), 0.76 + 0.06 * np.sin(am)], axis=-1)
    ai = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    mouth_i = np.stack([0.50 + 0.08 * np.cos(ai), 0.76 + 0.03 * np.sin(ai)], axis=-1)
    return np.concatenate([jaw, brow_l, brow_r, nose_v, nose_b, eye_l, eye_r, mouth_o,
                           mouth_i], axis=0).astype(np.float32)


def _skin_bbox(img: np.ndarray) -> tuple[float, float, float, float]:
    """Skin-tone bounding box (r > g > b), else the centre square.
    Returns (x0, y0, w, h) in pixels."""
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    skin = (r > 70) & (r > g) & (g > b) & (r - b > 10)
    ys, xs = np.nonzero(skin)
    h, w = img.shape[:2]
    if len(xs) < 0.005 * h * w:
        s = 0.5 * min(h, w)
        return (w - s) / 2, (h - s) / 2, s, s
    x0, x1 = np.percentile(xs, [2, 98])
    y0, y1 = np.percentile(ys, [2, 98])
    return float(x0), float(y0), float(max(x1 - x0, 1)), float(max(y1 - y0, 1))


def _fallback_landmarks(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    x0, y0, bw, bh = _skin_bbox(img)
    tpl = _template68()
    lmk2d = np.stack([x0 + tpl[:, 0] * bw, y0 + tpl[:, 1] * bh], axis=-1)
    z = (0.15 - 0.3 * np.abs(tpl[:, 0] - 0.5)) * bw   # crude convexity
    lmk3d = np.concatenate([lmk2d, z[:, None]], axis=-1)
    return lmk2d.astype(np.float32), lmk3d.astype(np.float32)


def _save_vis(img: np.ndarray, lmk: np.ndarray, path: str) -> None:
    vis = img.copy()
    for x, y in lmk[:, :2]:
        xi, yi = int(round(x)), int(round(y))
        vis[max(yi - 1, 0):yi + 2, max(xi - 1, 0):xi + 2] = (0, 255, 0)
    write_png(path, vis)


def read_image(path: str) -> np.ndarray:
    """uint8 [H, W, 3] of an 8-bit PNG (PIL's ``convert("RGB")``: alpha
    dropped, gray replicated); any other format raises."""
    with open(path, "rb") as f:
        if f.read(8) != _PNG_SIGNATURE:
            raise NotImplementedError(
                f"{path}: not a PNG; the port reads PNG images only (no JPEG or "
                "other decoder on the GPU machine): convert the images to PNG beforehand")
    return imread_rgb(path)


def main(argv=None) -> tuple[dict, dict]:
    ap = argparse.ArgumentParser("calc_face_alignment")
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--image_dir", default="images")
    ap.add_argument("--landmarks_dir", default="",
                    help="precomputed <basename>_2d.npy/_3d.npy per image")
    ap.add_argument("--external_cmd", default="",
                    help="detector command: CMD <image> <out2d.npy> <out3d.npy>")
    ap.add_argument("--no_vis", action="store_true")
    args = ap.parse_args(argv)

    image_paths = sorted(glob(os.path.join(args.data_path, args.image_dir, "*")))
    out_dir = os.path.join(args.data_path, "face_alignment")
    os.makedirs(os.path.join(out_dir, "vis_2d"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "vis_3d"), exist_ok=True)

    lmks_2d: dict = {}
    lmks_3d: dict = {}
    for path in image_paths:
        basename = os.path.basename(path).split(".")[0]
        img = read_image(path)
        l2 = l3 = None
        if args.landmarks_dir:
            p2 = os.path.join(args.landmarks_dir, f"{basename}_2d.npy")
            p3 = os.path.join(args.landmarks_dir, f"{basename}_3d.npy")
            if os.path.exists(p2):
                l2 = np.load(p2)
            if os.path.exists(p3):
                l3 = np.load(p3)
        elif args.external_cmd:
            with tempfile.TemporaryDirectory() as td:
                o2, o3 = os.path.join(td, "l2.npy"), os.path.join(td, "l3.npy")
                subprocess.run(args.external_cmd.split() + [path, o2, o3], check=True)
                if os.path.exists(o2):
                    l2 = np.load(o2)
                if os.path.exists(o3):
                    l3 = np.load(o3)
        else:
            l2, l3 = _fallback_landmarks(img)
        if l2 is not None:
            lmks_2d[basename] = np.asarray(l2, np.float32)
            if not args.no_vis:
                _save_vis(img, l2, os.path.join(out_dir, "vis_2d", f"{basename}.png"))
        if l3 is not None:
            lmks_3d[basename] = np.asarray(l3, np.float32)
            if not args.no_vis:
                _save_vis(img, l3, os.path.join(out_dir, "vis_3d", f"{basename}.png"))

    with open(os.path.join(out_dir, "lmks_2d.pkl"), "wb") as f:
        pickle.dump(lmks_2d, f)
    with open(os.path.join(out_dir, "lmks_3d.pkl"), "wb") as f:
        pickle.dump(lmks_3d, f)
    print(f"face_alignment: {len(lmks_2d)} views -> {out_dir}")
    return lmks_2d, lmks_3d


if __name__ == "__main__":
    main()
