"""Hair / face / body masks (port of ``gaussianhaircut_tpu/cli/calc_masks.py``;
contract of src/preprocessing/calc_masks.py: writes
``masks/{hair,face,body}/<frame>.png``).

    python3 -m gaussianhaircut_torch.cli.calc_masks --scene_path SCENE [--images_dir input]

The reference runs Matte-Anything (GroundingDINO boxes -> SAM -> trimap ->
ViTMatte) in its own environment.  As in the JAX package, this CLI either
runs ``--external_cmd`` (the run.sh-style hand-off), or falls back to a
classical segmentation for smoke tests on controlled captures: GrabCut from a
centred rectangle for the body, a YCrCb skin gate for the face and the dark
part of the body for the hair.

The JAX package calls OpenCV; the GPU machine has none, so the fallback is
written here:

- ``grabcut`` is OpenCV's GrabCut (``grabcut.cpp``): five-component
  full-covariance colour GMMs for foreground and background, each started by
  k-means++ (10 iterations), 3 rounds of component assignment, learning and
  a min cut with gamma 50, lambda 9 * gamma and 8-neighbour n-links whose
  beta comes from the mean squared colour difference.  All of it runs on
  the device, the min cut too (``min_cut``: push-relabel on integer
  capacities, exact; scipy's ``maximum_flow`` on the host is several times
  slower at 1920x1088 and is the tests' reference).  The
  k-means draws come from a seeded ``torch.Generator``, not OpenCV's RNG,
  and a min cut's ties may fall either way, so ``body`` agrees with
  ``cv2.grabCut`` by overlap, not bit for bit.
- Everything after ``body`` is OpenCV's to the byte: ``cvtColor`` to YCrCb
  and to gray with its fixed-point weights, ``inRange``, ``np.percentile``'s
  linear interpolation and a 7x7 ``MORPH_CLOSE`` with OpenCV's border rule.

Images are read as PNG only (``utils/image.read_png``; no other decoder on
the GPU machine); other files in the image directory are skipped.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.preprocessing.frames import cvt_gray, imread_rgb
from gaussianhaircut_torch.utils.image import write_png

# OpenCV's GrabCut labels and constants (grabcut.cpp)
GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD = 0, 1, 2, 3
COMPONENTS = 5
GAMMA = 50.0
LAMBDA = 9 * GAMMA
ITERATIONS = 3
KMEANS_ITERS = 10
# min-cut capacities are rounded to multiples of 1 / CAP_SCALE (int64)
CAP_SCALE = 1024
# YCrCb skin gate of the JAX fallback: (Y, Cr, Cb) bounds, inclusive
SKIN_LO, SKIN_HI = (0, 135, 85), (255, 180, 135)
DARK_PERCENTILE = 45
CLOSE_SIZE = 7

# seconds of grabcut_masks' work: the min cuts, and all else; summed over
# calls (a caller resets them)
timings = {"min_cut_s": 0.0, "other_s": 0.0}


def rect_mask(h: int, w: int) -> np.ndarray:
    """``GC_INIT_WITH_RECT`` for the JAX fallback's rectangle
    (w/8, h/12, 3w/4, 9h/10), clipped to the image as OpenCV clips it."""
    x, y, rw, rh = w // 8, h // 12, w * 3 // 4, h * 9 // 10
    rw, rh = min(rw, w - x), min(rh, h - y)
    mask = np.full((h, w), GC_BGD, np.uint8)
    mask[y:y + rh, x:x + rw] = GC_PR_FGD
    return mask


def _kmeans_pp(x: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """k-means++ centres of ``x`` [n, 3] (OpenCV's ``generateCentersPP``:
    three candidates per centre, the one with the least total distance
    kept), then ``KMEANS_ITERS`` Lloyd steps -> labels [n] int64."""
    n = x.shape[0]
    k = min(k, n)
    dev = x.device
    first = int(torch.randint(n, (1,), generator=gen, device=dev))
    centres = [x[first]]
    dist = ((x - x[first]) ** 2).sum(1)
    for _ in range(1, k):
        total = dist.sum()
        if float(total) <= 0:
            centres.append(x[int(torch.randint(n, (1,), generator=gen, device=dev))])
            continue
        cand = torch.multinomial(dist / total, 3, replacement=True, generator=gen)
        cand_d = torch.minimum(dist[None], ((x[None] - x[cand][:, None]) ** 2).sum(2))
        best = int(torch.argmin(cand_d.sum(1)))
        centres.append(x[cand[best]])
        dist = cand_d[best]
    c = torch.stack(centres)
    for _ in range(KMEANS_ITERS):
        # one-hot products, not index_add_: atomics would make the sums vary
        onehot = F.one_hot(torch.cdist(x, c).argmin(1), k).to(x.dtype)
        count = onehot.sum(0)
        c = torch.where(count[:, None] > 0, onehot.T @ x / count.clamp(min=1)[:, None], c)
    return torch.cdist(x, c).argmin(1)


class _Gmm:
    """OpenCV's ``GMM``: weights, means, covariances (float64), learned from
    samples and their component labels."""

    def __init__(self, x: torch.Tensor, labels: torch.Tensor):
        x = x.to(torch.float64)
        k = COMPONENTS
        onehot = F.one_hot(labels, k).to(torch.float64)        # deterministic sums
        count = onehot.sum(0)
        sums = onehot.T @ x
        prods = onehot.T @ (x[:, :, None] * x[:, None, :]).reshape(-1, 9)
        n = count.clamp(min=1)[:, None]
        self.coef = count / count.sum()
        self.mean = sums / n
        cov = (prods / n).reshape(k, 3, 3) - self.mean[:, :, None] * self.mean[:, None, :]
        det = torch.linalg.det(cov)
        # the singular fix: white noise 0.01 on the diagonal
        fix = (det <= 1e-6)[:, None, None] * 0.01 * torch.eye(3, dtype=torch.float64,
                                                                 device=x.device)
        self.live = self.coef > 0
        # an empty component gets the identity (its density is never used)
        cov = torch.where(self.live[:, None, None], cov + fix,
                          torch.eye(3, dtype=torch.float64, device=x.device))
        self.inv = torch.linalg.inv(cov)
        self.logdet = torch.log(torch.linalg.det(cov))

    def component_logp(self, x: torch.Tensor) -> torch.Tensor:
        """log of each component's unweighted density (OpenCV's
        ``1 / sqrt(det) * exp(-mult / 2)``) -> [n, k]; -inf for empty
        components."""
        d = x.to(torch.float64)[:, None, :] - self.mean[None]
        mult = torch.einsum("nki,kij,nkj->nk", d, self.inv, d)
        lp = -0.5 * self.logdet[None] - 0.5 * mult
        return torch.where(self.live[None], lp, -torch.inf)

    def which(self, x: torch.Tensor) -> torch.Tensor:
        return self.component_logp(x).argmax(1)

    def neg_log(self, x: torch.Tensor) -> torch.Tensor:
        """-log(sum_k coef_k density_k(x)) in float64."""
        return -torch.logsumexp(self.component_logp(x) + torch.log(self.coef)[None], 1)


# the eight neighbours (dy, dx) of a pixel; the opposite of k is (k + 4) % 8
_OFFSETS = ((0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1))
_FAR = 1 << 30               # the height of a pixel that cannot reach the sink
GLOBAL_RELABEL_EVERY = 64


def _neighbours(t: torch.Tensor, fill) -> torch.Tensor:
    """[..., H, W] -> [8, ..., H, W]: out[k, ..., y, x] = t[..., y + dy_k,
    x + dx_k], ``fill`` off the image."""
    h, w = t.shape[-2:]
    p = F.pad(t, (1, 1, 1, 1), value=fill)
    return torch.stack([p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w] for dy, dx in _OFFSETS])


def n_links(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``calcBeta`` / ``calcNWeights`` for uint8 [H, W, 3]: the
    capacity of each pixel's link to each of its eight neighbours, [8, H, W]
    float64, zero off the image: gamma exp(-beta |dc|^2), divided by
    sqrt(2) (OpenCV's float sqrt) on the diagonals, with beta = 1 / (2 mean
    |dc|^2) over the image's neighbour pairs."""
    h, w = img.shape[:2]
    c = img.to(torch.float64).permute(2, 0, 1)
    diff = ((c[None] - _neighbours(c, float("nan"))) ** 2).sum(1)
    total = float(diff[:4].nan_to_num(0.0).sum())      # each pair once
    pairs = 4 * w * h - 3 * w - 3 * h + 2
    beta = 0.0 if total <= np.finfo(np.float64).eps else 1.0 / (2 * total / pairs)
    diag = GAMMA / float(np.sqrt(np.float32(2.0)))
    scale = torch.tensor([GAMMA if 0 in off else diag for off in _OFFSETS],
                         dtype=torch.float64, device=img.device)
    return (scale[:, None, None] * torch.exp(-beta * diff)).nan_to_num(0.0)


def _shift(t: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = t[y + dy, x + dx], zero off the image."""
    h, w = t.shape
    return F.pad(t, (1, 1, 1, 1))[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _distance_to_sink(res: torch.Tensor, to_sink: torch.Tensor) -> torch.Tensor:
    """Each pixel's least number of residual links to the sink (int32
    [H, W]; ``_FAR`` where there is no such path), by breadth-first sweeps."""
    dist = torch.where(to_sink > 0, 1, _FAR).to(torch.int32)
    while True:
        step = torch.where(res > 0, _neighbours(dist, _FAR), _FAR).amin(0) + 1
        nxt = torch.minimum(dist, step)
        if torch.equal(nxt, dist):
            return dist
        dist = nxt


def min_cut(links: torch.Tensor, from_source: torch.Tensor, to_sink: torch.Tensor):
    """The source side (bool [H, W]) of a minimum s-t cut of the pixel graph
    with link capacities ``links`` [8, H, W] (symmetric) and terminal
    capacities [H, W], all rounded to multiples of 1 / CAP_SCALE: a maximum
    preflow by push-relabel on the device, in int64 (every pixel pushes to
    the sink, then to each neighbour in turn, then relabels; exact distance
    labels every GLOBAL_RELABEL_EVERY rounds); the source side is what can
    no longer reach the sink.  Only the difference of a pixel's terminal
    capacities matters (OpenCV's ``GCGraph::addTermWeights`` keeps the
    same)."""
    res = torch.round(links * CAP_SCALE).to(torch.int64)
    d = torch.round((from_source - to_sink) * CAP_SCALE).to(torch.int64)
    excess, sink = d.clamp(min=0), (-d).clamp(min=0)
    height = _distance_to_sink(res, sink)
    rounds = 0
    while True:
        active = (excess > 0) & (height < _FAR)
        if not bool(active.any()):
            return _distance_to_sink(res, sink) >= _FAR
        flow = torch.where(active & (height == 1), torch.minimum(excess, sink), 0)
        excess -= flow
        sink -= flow
        below = _neighbours(height, _FAR) + 1
        for k, (dy, dx) in enumerate(_OFFSETS):
            flow = torch.where((excess > 0) & (res[k] > 0) & (height == below[k]),
                               torch.minimum(excess, res[k]), 0)
            excess -= flow
            res[k] -= flow
            arrived = _shift(flow, -dy, -dx)
            excess += arrived
            res[(k + 4) % 8] += arrived
        lowest = torch.where(res > 0, _neighbours(height, _FAR), _FAR).amin(0) + 1
        lowest = torch.where(sink > 0, 1, lowest)
        height = torch.where((excess > 0) & (height < _FAR) & (lowest > height), lowest,
                             height)
        rounds += 1
        if rounds % GLOBAL_RELABEL_EVERY == 0:
            height = _distance_to_sink(res, sink)


def grabcut(img_bgr: np.ndarray, mask: np.ndarray, device) -> np.ndarray:
    """``cv2.grabCut(img, mask, None, bgd, fgd, ITERATIONS,
    GC_INIT_WITH_MASK)`` on a uint8 [H, W, 3] image and a GC_* label mask
    -> the new label mask (uint8 [H, W]); the k-means draws are seeded."""
    dev = resolve_device(device)
    h, w = mask.shape
    t0 = time.perf_counter()
    img = torch.as_tensor(np.ascontiguousarray(img_bgr), device=dev)
    x = img.reshape(-1, 3).to(torch.float32)
    lab = torch.as_tensor(mask.reshape(-1), device=dev)
    is_bg = (lab == GC_BGD) | (lab == GC_PR_BGD)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bgd, fgd = (_Gmm(x[side], _kmeans_pp(x[side], COMPONENTS, gen))
                for side in (is_bg, ~is_bg))
    links = n_links(img)
    other_s, cut_s = time.perf_counter() - t0, 0.0
    for _ in range(ITERATIONS):
        t0 = time.perf_counter()
        # each pixel takes its likeliest component of its side's GMM, then
        # both GMMs are learned again from those components
        comp = torch.where(is_bg, bgd.which(x), fgd.which(x))
        bgd, fgd = _Gmm(x[is_bg], comp[is_bg]), _Gmm(x[~is_bg], comp[~is_bg])
        unknown = (lab == GC_PR_BGD) | (lab == GC_PR_FGD)
        from_source = torch.where(unknown, bgd.neg_log(x),
                                  torch.where(lab == GC_BGD, 0.0, LAMBDA))
        to_sink = torch.where(unknown, fgd.neg_log(x),
                              torch.where(lab == GC_BGD, LAMBDA, 0.0))
        t1 = time.perf_counter()
        src = min_cut(links, from_source.reshape(h, w), to_sink.reshape(h, w)).reshape(-1)
        t2 = time.perf_counter()
        lab = torch.where(unknown, torch.where(src, GC_PR_FGD, GC_PR_BGD), lab).to(torch.uint8)
        is_bg = (lab == GC_BGD) | (lab == GC_PR_BGD)
        cut_s += t2 - t1
        other_s += t1 - t0
    timings["other_s"] += other_s
    timings["min_cut_s"] += cut_s
    return lab.reshape(h, w).cpu().numpy()


def bgr_to_ycrcb(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``cvtColor(BGR2YCrCb)`` for uint8 [..., 3] (14-bit
    fixed point: Y from 1868 / 9617 / 4899, Cr 11682 (R - Y), Cb 9241
    (B - Y), both + 128, rounded and saturated)."""
    c = img.to(torch.int64)
    b, g, r = c[..., 0], c[..., 1], c[..., 2]
    half = 1 << 13
    y = (b * 1868 + g * 9617 + r * 4899 + half) >> 14
    cr = ((r - y) * 11682 + (128 << 14) + half) >> 14
    cb = ((b - y) * 9241 + (128 << 14) + half) >> 14
    return torch.stack([y, cr, cb], -1).clamp(0, 255).to(torch.uint8)


def in_range(img: torch.Tensor, lo, hi) -> torch.Tensor:
    """``cv2.inRange``: 255 where every channel lies in [lo, hi]."""
    lo = torch.tensor(lo, dtype=img.dtype, device=img.device)
    hi = torch.tensor(hi, dtype=img.dtype, device=img.device)
    inside = ((img >= lo) & (img <= hi)).all(-1)
    return inside.to(torch.uint8) * 255


def percentile_u8(values: torch.Tensor, q: float) -> float:
    """``np.percentile(values, q)`` of uint8 values (linear interpolation),
    from their histogram."""
    n = values.numel()
    cum = torch.cumsum(torch.bincount(values.reshape(-1).to(torch.int64), minlength=256),
                       0).cpu().numpy()
    vi = (q / 100.0) * (n - 1)
    lo = int(np.floor(vi))
    hi = min(lo + 1, n - 1)
    a, b = (float(np.searchsorted(cum, k, side="right")) for k in (lo, hi))
    t = vi - lo
    # numpy's _lerp: a + (b - a) t, from the other end when t >= 0.5
    return b - (b - a) * (1 - t) if t >= 0.5 else a + (b - a) * t


def morph_close(mask: torch.Tensor) -> torch.Tensor:
    """``cv2.morphologyEx(mask, MORPH_CLOSE, ones((7, 7)))`` on a uint8
    [H, W] mask: dilation, then erosion; the border is ignored by both (the
    default border value of OpenCV's morphology)."""
    x = mask.to(torch.float32)[None, None]
    pad = CLOSE_SIZE // 2
    x = F.max_pool2d(x, CLOSE_SIZE, 1, pad)
    x = -F.max_pool2d(-x, CLOSE_SIZE, 1, pad)
    return x[0, 0].to(torch.uint8)


def masks_from_body(img_bgr: np.ndarray, body: np.ndarray, device=None):
    """(hair, face) uint8 masks from the image and the body mask: the skin
    gate inside the body, and the body's dark non-face part (gray under its
    45th percentile), closed with a 7x7 square."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.ascontiguousarray(img_bgr), device=dev)
    body_t = torch.as_tensor(body, device=dev)
    skin = in_range(bgr_to_ycrcb(img), SKIN_LO, SKIN_HI)
    face = skin & body_t
    gray = cvt_gray(img.flip(-1).to(torch.int64)).to(torch.uint8)
    inside = body_t > 0
    if bool(inside.any()):
        dark = gray.to(torch.float64) < percentile_u8(gray[inside], DARK_PERCENTILE)
    else:
        dark = gray < 64
    hair = (dark.to(torch.uint8) * 255) & body_t & ~face
    hair = morph_close(hair)
    return hair.cpu().numpy(), face.cpu().numpy()


def grabcut_masks(img_bgr: np.ndarray, device=None):
    """(hair, face, body) uint8 masks of a BGR image: GrabCut from the
    rectangle (w/8, h/12, 3w/4, 9h/10) for the body, then
    ``masks_from_body``."""
    dev = resolve_device(device)
    h, w = img_bgr.shape[:2]
    labels = grabcut(img_bgr, rect_mask(h, w), dev)
    body = np.where((labels == GC_BGD) | (labels == GC_PR_BGD), 0, 255).astype(np.uint8)
    t0 = time.perf_counter()
    hair, face = masks_from_body(img_bgr, body, dev)
    timings["other_s"] += time.perf_counter() - t0
    return hair, face, body


def main(argv=None):
    parser = argparse.ArgumentParser("calc_masks")
    parser.add_argument("--scene_path", required=True)
    parser.add_argument("--images_dir", default="input")
    parser.add_argument("--external_cmd", default="",
                        help="command to run instead (Matte-Anything env); "
                             "receives the scene path via {scene}")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda")
    args = parser.parse_args(argv)

    if args.external_cmd:
        cmd = args.external_cmd.format(scene=args.scene_path)
        print("+", cmd)
        sys.exit(subprocess.call(cmd, shell=True))

    device = resolve_device(args.device)
    print("[warn] running classical fallback segmentation — for production "
          "quality provide --external_cmd running Matte-Anything")
    src = os.path.join(args.scene_path, args.images_dir)
    for sub in ("hair", "face", "body"):
        os.makedirs(os.path.join(args.scene_path, "masks", sub), exist_ok=True)
    for name in sorted(os.listdir(src)):
        if not name.lower().endswith(".png"):
            continue
        bgr = np.ascontiguousarray(imread_rgb(os.path.join(src, name))[..., ::-1])
        hair, face, body = grabcut_masks(bgr, device)
        for sub, m in (("hair", hair), ("face", face), ("body", body)):
            write_png(os.path.join(args.scene_path, "masks", sub, name), m)


if __name__ == "__main__":
    main()
