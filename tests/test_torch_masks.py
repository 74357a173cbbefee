"""The port's mask fallback (``cli/calc_masks.py``) against OpenCV and the
JAX package's ``grabcut_masks``, which calls OpenCV:

- ``grabcut_masks``' ``body`` has an IoU of at least 0.9 with
  ``cv2.grabCut``'s on the portrait frames of tests/test_masks_fallback.py
  (the k-means draws cannot match OpenCV's RNG, so ``body`` is held by
  overlap; these frames give 1.0);
- given the JAX function's ``body`` (cv2's), ``hair`` and ``face`` are
  byte-equal to the JAX function's;
- the conversions are OpenCV's on 10^6 random pixels: ``cvtColor`` to
  YCrCb and to gray, ``inRange``, ``np.percentile`` and the 7x7
  ``MORPH_CLOSE``;
- the device min cut (push-relabel) costs what scipy's ``maximum_flow``
  says is least, on random grids;
- the CLI writes the three masks of each PNG as PNG and runs
  ``--external_cmd`` instead when it is given."""
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.cli import calc_masks as j_calc_masks
from gaussianhaircut_torch.cli import calc_masks as cm
from gaussianhaircut_torch.preprocessing.frames import cvt_gray
from gaussianhaircut_torch.utils.image import read_png, write_png
from tests.test_masks_fallback import _portrait

IOU_MIN = 0.9


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


@pytest.mark.parametrize("res, seed", [(96, 0), (96, 1), (80, 2)])
def test_grabcut_body_overlaps_cv2(res, seed):
    img = _portrait(res, seed)[0]
    h, w = img.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    cv2.grabCut(img, mask, (w // 8, h // 12, w * 3 // 4, h * 9 // 10),
                np.zeros((1, 65)), np.zeros((1, 65)), 3, cv2.GC_INIT_WITH_RECT)
    ref = (mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)
    hair, face, body = cm.grabcut_masks(img, "cpu")
    assert body.dtype == np.uint8 and set(np.unique(body)) <= {0, 255}
    assert _iou(body > 0, ref) >= IOU_MIN, _iou(body > 0, ref)
    assert ((hair > 0) & (face > 0)).sum() < 0.1 * max((hair > 0).sum(), 1)


@pytest.mark.parametrize("seed", [0, 3])
def test_masks_from_cv2_body_equal_jax(seed):
    img = _portrait(96, seed)[0]
    hair, face, body = j_calc_masks.grabcut_masks(img)
    got_hair, got_face = cm.masks_from_body(img, body, "cpu")
    np.testing.assert_array_equal(got_face, face)
    np.testing.assert_array_equal(got_hair, hair)
    assert (hair > 0).sum() > 20 and (face > 0).sum() > 20


def test_conversions_match_cv2_on_a_million_pixels():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (1000, 1000, 3), dtype=np.uint8)
    t = torch.as_tensor(img)
    ycrcb = cm.bgr_to_ycrcb(t).numpy()
    np.testing.assert_array_equal(ycrcb, cv2.cvtColor(img, cv2.COLOR_BGR2YCrCb))
    np.testing.assert_array_equal(cm.in_range(torch.as_tensor(ycrcb), cm.SKIN_LO, cm.SKIN_HI)
                                  .numpy(), cv2.inRange(ycrcb, cm.SKIN_LO, cm.SKIN_HI))
    gray = cvt_gray(t.flip(-1).to(torch.int64)).to(torch.uint8).numpy()
    np.testing.assert_array_equal(gray, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    for q in (45, 0, 100, 12.5):
        assert cm.percentile_u8(torch.as_tensor(gray[:777]), q) == np.percentile(gray[:777], q)
    # sparse and dense masks, and blobs touching the border
    for p in (0.02, 0.5, 0.97):
        m = np.where(rng.random((1000, 1000)) < p, 255, 0).astype(np.uint8)
        np.testing.assert_array_equal(
            cm.morph_close(torch.as_tensor(m)).numpy(),
            cv2.morphologyEx(m, cv2.MORPH_CLOSE, np.ones((7, 7), np.uint8)))


@pytest.mark.parametrize("seed", range(4))
def test_min_cut_costs_the_max_flow(seed):
    """The push-relabel cut of ``min_cut`` costs what scipy's
    ``maximum_flow`` of the same integer graph says is least, on random
    grids with sparse links and terminal links of both signs."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_flow
    rng = np.random.default_rng(seed)
    h, w = 9, 13
    half = torch.as_tensor(rng.uniform(0, 50, (4, h, w)) * (rng.random((4, h, w)) < 0.8))
    links = torch.zeros(8, h, w, dtype=torch.float64)
    for k in range(4):                   # symmetric: the back link sits at the neighbour
        dy, dx = cm._OFFSETS[k]
        valid = torch.zeros(h, w, dtype=torch.bool)
        valid[max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = True
        links[k] = torch.where(valid, half[k], 0.0)
        links[k + 4] = cm._shift(links[k], -dy, -dx)
    fs = torch.as_tensor(rng.uniform(0, 300, (h, w)) * (rng.random((h, w)) < 0.5))
    ts = torch.as_tensor(rng.uniform(0, 300, (h, w)) * (rng.random((h, w)) < 0.5))
    src = cm.min_cut(links, fs, ts).numpy()
    q = lambda t: np.rint(np.asarray(t) * cm.CAP_SCALE).astype(np.int64)
    d = q(fs - ts)
    lq = q(links)
    cost = np.where(src, np.maximum(-d, 0), np.maximum(d, 0)).sum()
    idx = np.arange(h * w).reshape(h, w)
    rows, cols, caps = [], [], []
    for k, (dy, dx) in enumerate(cm._OFFSETS):
        ys, xs = np.nonzero(lq[k] > 0)
        rows.append(idx[ys, xs])
        cols.append(idx[ys + dy, xs + dx])
        caps.append(lq[k][ys, xs])
        cost += (lq[k][ys, xs] * (src[ys, xs] & ~src[ys + dy, xs + dx])).sum()
    n = h * w
    rows += [np.full(n, n), idx.ravel()]
    cols += [idx.ravel(), np.full(n, n + 1)]
    caps += [np.maximum(d, 0).ravel(), np.maximum(-d, 0).ravel()]
    graph = sp.csr_array((np.concatenate(caps).astype(np.int32),
                          (np.concatenate(rows), np.concatenate(cols))), shape=(n + 2, n + 2))
    graph.eliminate_zeros()
    assert cost == maximum_flow(graph, n, n + 1).flow_value


def test_calc_masks_cli(tmp_path):
    scene = tmp_path / "scene"
    imgs = {f"{i:06d}.png": _portrait(64, i)[0] for i in range(2)}
    for name, bgr in imgs.items():
        write_png(str(scene / "input" / name), np.ascontiguousarray(bgr[..., ::-1]))
    (scene / "input" / "notes.txt").write_text("not an image")
    cm.main(["--scene_path", str(scene), "--device", "cpu"])
    for name, bgr in imgs.items():
        want = cm.grabcut_masks(bgr, "cpu")
        for sub, m in zip(("hair", "face", "body"), want):
            np.testing.assert_array_equal(read_png(str(scene / "masks" / sub / name)), m)
    assert sorted(os.listdir(scene / "masks" / "body")) == sorted(imgs)

    marker = tmp_path / "ran"
    cmd = f"{sys.executable} -c \"open('{marker}', 'w').write('{{scene}}')\""
    with pytest.raises(SystemExit) as e:
        cm.main(["--scene_path", str(scene), "--external_cmd", cmd])
    assert e.value.code == 0 and marker.read_text() == str(scene)
