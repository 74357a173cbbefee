"""Times the mask fallback's GrabCut (``cli/calc_masks.grabcut_masks``) on a
synthetic 1920x1088 portrait twice: with its min cut (push-relabel on the
device) and with scipy's ``maximum_flow`` on the host in its place, the same
integer graph; prints one JSON line with both runs' seconds, split into the
three min cuts and the rest, and whether the two ``body`` masks agree.

    python3 -m gaussianhaircut_torch.tools.profile_min_cut [--noise 8] [--device cpu]

The portrait is the one of tests/test_masks_fallback.py drawn without
OpenCV (background, torso, face and hair), centred on a 1920x1088 canvas,
with uniform noise of +-``noise`` levels, which weakens the n-links and makes
the cut harder.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gaussianhaircut_torch.cli import calc_masks
from gaussianhaircut_torch.device import resolve_device


def portrait(height: int, width: int, noise: int, seed: int = 0) -> np.ndarray:
    """uint8 [height, width, 3] BGR: a square head-and-shoulders drawing of
    side ``height`` on a light background, with +-``noise`` uniform noise."""
    res = height
    img = np.full((height, width, 3), (225, 215, 205), np.int64)
    x0 = (width - res) // 2
    yy, xx = np.mgrid[:res, :res]
    cx, cy = res // 2, int(res * 0.42)
    tile = img[:, x0:x0 + res]
    tile[int(res * 0.70):, int(res * 0.25):int(res * 0.75)] = (90, 60, 50)
    tile[((xx - cx) / (res * 0.16)) ** 2 + ((yy - cy) / (res * 0.20)) ** 2 <= 1] = (140, 160, 215)
    hcy = cy - int(res * 0.10)
    hair = ((xx - cx) / (res * 0.20)) ** 2 + ((yy - hcy) / (res * 0.16)) ** 2 <= 1
    tile[hair & (yy <= hcy)] = (25, 22, 28)
    if noise:
        img += np.random.default_rng(seed).integers(-noise, noise, img.shape)
    return img.clip(0, 255).astype(np.uint8)


def scipy_min_cut(links: torch.Tensor, from_source: torch.Tensor,
                  to_sink: torch.Tensor) -> torch.Tensor:
    """``calc_masks.min_cut`` by ``scipy.sparse.csgraph.maximum_flow`` on
    the host, with the same rounding; the source side is what the source
    reaches in the residual graph."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow
    q = lambda t: np.rint(t.cpu().numpy() * calc_masks.CAP_SCALE).astype(np.int64)
    lq, d = q(links), q(from_source - to_sink)
    h, w = d.shape
    n = h * w
    idx = np.arange(n).reshape(h, w)
    rows, cols, caps = [], [], []
    for k, (dy, dx) in enumerate(calc_masks._OFFSETS):
        ys, xs = np.nonzero(lq[k] > 0)
        rows.append(idx[ys, xs])
        cols.append(idx[ys + dy, xs + dx])
        caps.append(lq[k][ys, xs])
    src, snk = d.ravel() > 0, d.ravel() < 0
    rows += [np.full(int(src.sum()), n), idx.ravel()[snk]]
    cols += [idx.ravel()[src], np.full(int(snk.sum()), n + 1)]
    caps += [d.ravel()[src], -d.ravel()[snk]]
    cap = sp.csr_array((np.concatenate(caps).astype(np.int32),
                        (np.concatenate(rows), np.concatenate(cols))), shape=(n + 2, n + 2))
    res = (cap - maximum_flow(cap, n, n + 1).flow).tocsr()
    res.data = np.maximum(res.data, 0)
    res.eliminate_zeros()
    side = np.zeros(n + 2, bool)
    side[breadth_first_order(res, n, directed=True, return_predecessors=False)] = True
    return torch.as_tensor(side[:n].reshape(h, w), device=links.device)


def run(img: np.ndarray, device, cut) -> dict:
    """grabcut_masks with ``cut`` as its min cut -> seconds and the body."""
    calc_masks.timings.update(min_cut_s=0.0, other_s=0.0)
    default, calc_masks.min_cut = calc_masks.min_cut, cut
    try:
        t0 = time.perf_counter()
        body = calc_masks.grabcut_masks(img, device)[2]
        seconds = time.perf_counter() - t0
    finally:
        calc_masks.min_cut = default
    return {"s": seconds, **calc_masks.timings, "body": body}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--noise", type=int, default=8)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    img = portrait(1088, 1920, args.noise)
    out = {"size": [1920, 1088], "noise": args.noise, "device": str(dev),
           "device_name": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}
    runs = {name: run(img, dev, cut) for name, cut in (("push_relabel", calc_masks.min_cut),
                                                      ("scipy_maximum_flow", scipy_min_cut))}
    a, b = (runs[k].pop("body") > 0 for k in runs)
    out.update(runs, body_pixels=int(a.sum()), body_iou=float((a & b).sum() / max((a | b).sum(), 1)))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
