"""Frame filtering by image quality (port of ``gaussianhaircut_tpu/
preprocessing/frames.py``; reference src/preprocessing/preprocess_raw_images
.py:70-136 and filter_extra_images.py).

Images are read with the port's PNG codec as OpenCV reads them: ``imread(p)``
drops alpha and replicates gray; ``imread(p, 0)`` turns colour into gray with
libpng's fixed-point weights (red 9797, green 19234, blue 3737, over 2^15,
truncated), the conversion OpenCV asks libpng for.
"""
from __future__ import annotations

import os

import numpy as np

from gaussianhaircut_torch.utils.image import read_png


def imread_rgb(path: str) -> np.ndarray:
    """``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` of an 8-bit PNG:
    uint8 [H, W, 3]."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, -1)
    return img[..., :3]


def imread_gray(path: str) -> np.ndarray:
    """``cv2.imread(path, 0)`` of an 8-bit PNG: uint8 [H, W]."""
    img = read_png(path)
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:
        return img[..., 0]
    c = img[..., :3].astype(np.int64)
    return ((9797 * c[..., 0] + 19234 * c[..., 1] + 3737 * c[..., 2]) >> 15).astype(np.uint8)


def cvt_gray(c):
    """``cv2.cvtColor(RGB2GRAY)`` of int64 [..., 3] RGB values, numpy or
    torch: 15-bit fixed-point weights, rounded."""
    return (9798 * c[..., 0] + 19235 * c[..., 1] + 3735 * c[..., 2] + (1 << 14)) >> 15


def sharpness_iqa(img_rgb: np.ndarray) -> float:
    """Legacy no-reference quality score (higher is better): the variance of
    the 4-neighbour Laplacian (cv2.Laplacian, ksize 1, BORDER_REFLECT_101)
    of the gray image (``cvt_gray``) times the tonal spread."""
    gray = cvt_gray(np.asarray(img_rgb).astype(np.int64)).astype(np.uint8)
    x = gray.astype(np.float32)
    p = np.pad(x, 1, mode="reflect")
    lap = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]) - 4 * x
    spread = np.percentile(gray, 95) - np.percentile(gray, 5)
    return float(lap.var() * (spread / 255.0 + 1e-3))


def extract_frames(video_path: str, out_dir: str, target_frames: int = 256,
                   scorer=None, bin_keep: int = 1) -> list[str]:
    """Frame extraction from ``raw.mp4`` (preprocess_raw_images.py:70-122)
    needs a video decoder; the port's GPU machine has none (no OpenCV, no
    PyAV, no ffmpeg), so this stage is not ported."""
    raise NotImplementedError(
        f"extract_frames({video_path!r}): decoding a video needs a video decoder "
        "(OpenCV's VideoCapture in the JAX package), and the port has none; "
        f"extract the frames into {out_dir!r} as PNGs beforehand")


def filter_extra_images(scene_path: str, max_imgs: int = 128,
                        scorer=None, images_dir: str = "images",
                        masks_dir: str = "masks", device=None) -> list[str]:
    """Keep the best ``max_imgs`` frames by hair-crop quality; drop frames
    whose hair/face overlap exceeds 10% of the body (filter_extra_images.py
    :44-46).  Removes the rejected images and their masks from disk.
    ``scorer=None`` picks the best available tier (``iqa.default_scorer``,
    whose CNN tier runs on ``device``)."""
    if scorer is None:
        from gaussianhaircut_torch.preprocessing.iqa import default_scorer
        scorer = default_scorer(device)
    img_root = os.path.join(scene_path, images_dir)
    names = sorted(os.listdir(img_root))
    kept = []
    scored = []
    for name in names:
        img = imread_rgb(os.path.join(img_root, name))
        hair_p = os.path.join(scene_path, masks_dir, "hair", name)
        face_p = os.path.join(scene_path, masks_dir, "face", name)
        body_p = os.path.join(scene_path, masks_dir, "body", name)
        crop = img
        if os.path.exists(hair_p):
            hair = imread_gray(hair_p) > 127
            if os.path.exists(face_p) and os.path.exists(body_p):
                face = imread_gray(face_p) > 127
                body = imread_gray(body_p) > 127
                if body.sum() > 0 and (hair & face).sum() > 0.1 * body.sum():
                    scored.append((name, -np.inf))
                    continue
            ys, xs = np.nonzero(hair)
            if len(ys) > 16:
                crop = img[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
        scored.append((name, scorer(crop)))

    # histogram binning over time: the best frame per bin
    n_bins = min(max_imgs, len(scored))
    per_bin = max(1, len(scored) // n_bins)
    keep = set()
    for b in range(0, len(scored), per_bin):
        chunk = scored[b:b + per_bin]
        name, sc = max(chunk, key=lambda t: t[1])
        if sc > -np.inf and len(keep) < max_imgs:
            keep.add(name)

    for name in names:
        if name not in keep:
            for p in (os.path.join(img_root, name),
                      os.path.join(scene_path, masks_dir, "hair", name),
                      os.path.join(scene_path, masks_dir, "face", name),
                      os.path.join(scene_path, masks_dir, "body", name)):
                if os.path.exists(p):
                    os.remove(p)
        else:
            kept.append(name)
    return kept
