"""Scalp extraction: find the hair-covered head region, cut it as the scalp
submesh and paint its UV diffusion mask (port of
``gaussianhaircut_tpu/preprocessing/scalp.py``; reference
src/preprocessing/extract_non_visible_head_scalp.py:38-243).

The fitted head is rasterized into every view, per-vertex visibility is
accumulated under the dilated head-minus-hair mask, the vertices likely to
be under hair are cut as the scalp, and the 256^2 UV mask is painted.  The
same three files as the JAX package: ``scalp.obj`` with UVs,
``cut_scalp_verts.pickle`` and ``dif_mask.png``.

Without OpenCV and PIL:
- ``rasterize_pix_to_face`` is a z-buffer on a torch device: the pixels of
  every face's box, their barycentrics in float64 (the plain loop's
  arithmetic, operation by operation), then two scatter reductions that
  give the plain loop's winner exactly (see the function);
  ``rasterize_pix_to_face_plain`` is the JAX package's numpy loop;
- ``fill_poly`` is ``cv2.fillPoly`` (8-connected, no shift) transcribed:
  the edges drawn as Bresenham lines, then the scanline spans, so the mask
  is byte-equal to cv2's, edge pixels and degenerate or collinear
  triangles included;
- the 5x5 dilation is ``max_pool2d(5, 1, 2)``; ``cv2.imread(p, 0)`` is
  libpng's gray (``frames.imread_gray``); the PNG is PIL's bytes
  (``utils/image.write_png(..., like_pil=True)``).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F

from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.preprocessing.frames import imread_gray
from gaussianhaircut_torch.utils import mesh as mesh_util
from gaussianhaircut_torch.utils.image import write_png

# candidate (pixel, face) pairs per pass of the device z-buffer
CHUNK_PAIRS = 1 << 24


def rasterize_pix_to_face_plain(verts_pix: np.ndarray, depths: np.ndarray,
                                faces: np.ndarray, width: int, height: int) -> np.ndarray:
    """Z-buffered face index per pixel (-1 = background), one face at a time
    against a float32 depth buffer: the JAX package's loop.

    verts_pix [V, 2], depths [V] (camera z), faces [F, 3]."""
    zbuf = np.full((height, width), np.inf, np.float32)
    p2f = np.full((height, width), -1, np.int64)
    tri = verts_pix[faces]
    triz = depths[faces]
    valid = (triz > 1e-4).all(axis=1)
    for fi in np.nonzero(valid)[0]:
        t = tri[fi]
        x0 = max(int(np.floor(t[:, 0].min())), 0)
        x1 = min(int(np.ceil(t[:, 0].max())) + 1, width)
        y0 = max(int(np.floor(t[:, 1].min())), 0)
        y1 = min(int(np.ceil(t[:, 1].max())) + 1, height)
        if x0 >= x1 or y0 >= y1:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
        d = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float64)
        v0 = t[1] - t[0]
        v1 = t[2] - t[0]
        den = v0[0] * v1[1] - v1[0] * v0[1]
        if abs(den) < 1e-12:
            continue
        q = d - t[0]
        b1 = (q[:, 0] * v1[1] - v1[0] * q[:, 1]) / den
        b2 = (v0[0] * q[:, 1] - q[:, 0] * v0[1]) / den
        b0 = 1 - b1 - b2
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        if not inside.any():
            continue
        z = b0 * triz[fi, 0] + b1 * triz[fi, 1] + b2 * triz[fi, 2]
        px = d[inside].astype(np.int64)
        zi = z[inside]
        flat = px[:, 1] * width + px[:, 0]
        closer = zi < zbuf.reshape(-1)[flat]
        flat = flat[closer]
        zbuf.reshape(-1)[flat] = zi[closer]
        p2f.reshape(-1)[flat] = fi
    return p2f


def _candidates(tri: torch.Tensor, triz: torch.Tensor, face: torch.Tensor,
                box: torch.Tensor, width: int):
    """The pixels inside the faces ``face`` (their boxes ``box`` [n, 4] as
    x0, x1, y0, y1) -> (flat pixel, face, depth float64), with the plain
    loop's barycentrics and depth, operation by operation."""
    bw = box[:, 1] - box[:, 0]
    count = bw * (box[:, 3] - box[:, 2])
    rep = torch.repeat_interleave(torch.arange(len(face), device=tri.device), count)
    local = torch.arange(len(rep), device=tri.device) - (torch.cumsum(count, 0) - count)[rep]
    x = box[rep, 0] + local % bw[rep]
    y = box[rep, 2] + local // bw[rep]
    t = tri[face][rep]                                            # [n, 3, 2] float64
    v0 = t[:, 1] - t[:, 0]
    v1 = t[:, 2] - t[:, 0]
    den = v0[:, 0] * v1[:, 1] - v1[:, 0] * v0[:, 1]
    qx = x.to(torch.float64) - t[:, 0, 0]
    qy = y.to(torch.float64) - t[:, 0, 1]
    b1 = (qx * v1[:, 1] - v1[:, 0] * qy) / den
    b2 = (v0[:, 0] * qy - qx * v0[:, 1]) / den
    b0 = 1 - b1 - b2
    inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
    z3 = triz[face][rep]
    z = b0 * z3[:, 0] + b1 * z3[:, 1] + b2 * z3[:, 2]
    return (y * width + x)[inside], face[rep][inside], z[inside]


def rasterize_pix_to_face(verts_pix, depths, faces, width: int, height: int,
                          device=None) -> np.ndarray:
    """``rasterize_pix_to_face_plain``'s map, computed on ``device`` (CUDA
    unless ``device="cpu"``) without a loop over faces.

    The plain loop keeps a float32 depth buffer and lets a face in where its
    float64 depth is strictly below the stored float32 one.  The stored
    depth never rises, so it ends at R, the least float32-rounded depth of
    the pixel's faces; the first face rounding to R enters, and after it
    exactly the faces rounding to R whose float64 depth is below R.  So the
    winner is the LAST face that rounds to R with a depth below R, else the
    FIRST face that rounds to R: one amin over (float32 depth bits << 32 |
    face) keys, then one amax over the face indices of that set."""
    device = resolve_device(device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    faces_t = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    tri, triz = f64(verts_pix)[faces_t], f64(depths)[faces_t]
    t0, t1, t2 = tri[:, 0], tri[:, 1], tri[:, 2]
    v0, v1 = t1 - t0, t2 - t0
    den = v0[:, 0] * v1[:, 1] - v1[:, 0] * v0[:, 1]
    lo, hi = torch.amin(tri, dim=1), torch.amax(tri, dim=1)
    box = torch.stack([torch.clamp(torch.floor(lo[:, 0]), min=0),
                       torch.clamp(torch.ceil(hi[:, 0]) + 1, max=width),
                       torch.clamp(torch.floor(lo[:, 1]), min=0),
                       torch.clamp(torch.ceil(hi[:, 1]) + 1, max=height)], 1).to(torch.int64)
    keep = ((triz > 1e-4).all(dim=1) & (box[:, 0] < box[:, 1]) & (box[:, 2] < box[:, 3])
            & (torch.abs(den) >= 1e-12))
    face = torch.nonzero(keep)[:, 0]
    box = box[face]
    count = ((box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2])).cpu().numpy()
    # face batches of at most CHUNK_PAIRS candidate pixels (one face may exceed it)
    splits, start, acc = [], 0, 0
    for i, c in enumerate(count):
        if acc and acc + c > CHUNK_PAIRS:
            splits.append((start, i))
            start, acc = i, 0
        acc += int(c)
    splits.append((start, len(count)))

    npix = width * height
    first = torch.full((npix,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=device)
    for a, b in splits:                            # R and the first face at it
        pix, fi, z = _candidates(tri, triz, face[a:b], box[a:b], width)
        bits = z.to(torch.float32).view(torch.int32).to(torch.int64)   # z > 0: monotone
        first.scatter_reduce_(0, pix, bits << 32 | fi, "amin")
    hit = first != torch.iinfo(torch.int64).max
    r_bits = (first >> 32).to(torch.int32)
    r = torch.where(hit, r_bits, 0).view(torch.float32).to(torch.float64)
    last = torch.full((npix,), -1, dtype=torch.int64, device=device)
    for a, b in splits:                            # the last face below R
        pix, fi, z = _candidates(tri, triz, face[a:b], box[a:b], width)
        bits = z.to(torch.float32).view(torch.int32)
        below = (bits == r_bits[pix]) & (z < r[pix])
        last.scatter_reduce_(0, pix[below], fi[below], "amax")
    p2f = torch.where(last >= 0, last, torch.where(hit, first & 0xFFFFFFFF, -1))
    return p2f.reshape(height, width).cpu().numpy()


# ------------------------------------------------------ cv2.fillPoly --

_XY_SHIFT, _CEIL = 16, (1 << 16) - 1


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, p1: list, p2: list) -> bool:
    """OpenCV's ``clipLine`` on [x, y] lists, in place."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _line8(img: np.ndarray, p1, p2, color: int) -> None:
    """OpenCV's 8-connected ``Line``: a left-to-right Bresenham walk of the
    line clipped to the image."""
    h, w = img.shape
    p1, p2 = list(p1), list(p2)
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        if not _clip_line(w, h, p1, p2):
            return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = color
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:
            y += sy
            x += sx if step else 0
        else:
            x += sx
            y += sy if step else 0


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def fill_poly(img: np.ndarray, pts: np.ndarray, color: int = 255) -> None:
    """``cv2.fillPoly(img, [pts], color)`` on a uint8 [H, W] image, in
    place: integer (x, y) vertices, 8-connected edges, no shift
    (CollectPolyEdges and FillEdgeCollection of OpenCV's drawing.cpp).
    Byte-equal to cv2 5, also for vertices past the image: an edge whose
    line leaves the image is built from the clipped line's columns, as
    found against cv2 5.0.0 (OpenCV 4's source keeps the unclipped edge
    when the clipped line is horizontal)."""
    h, w = img.shape
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    pt0 = pts[-1]
    for pt1 in pts:
        t0, t1 = list(pt0), list(pt1)
        _line8(img, t0, t1, color)
        c0 = [pt0[0] << _XY_SHIFT, pt0[1]]
        c1 = [pt1[0] << _XY_SHIFT, pt1[1]]
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            # cv2 5: the edge takes the clipped line's columns, and its rows
            # too unless the clipped line is horizontal
            _clip_line(w, h, t0, t1)
            c0 = [t0[0] << _XY_SHIFT, pt0[1]]
            c1 = [t1[0] << _XY_SHIFT, pt1[1]]
            if t0[1] != t1[1]:
                c0 = [t0[0] << _XY_SHIFT, t0[1]]
                c1 = [t1[0] << _XY_SHIFT, t1[1]]
        if pt0[1] != pt1[1]:
            dx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edges.append(_Edge(pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx, dx))
            else:
                edges.append(_Edge(pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx, dx))
        pt0 = pt1
    _fill_edges(img, edges, color)


def _fill_edges(img: np.ndarray, edges: list, color: int) -> None:
    """OpenCV's FillEdgeCollection for 8-connected edges."""
    h, w = img.shape
    total = len(edges)
    if total < 2:
        return
    y_max, y_min = -(1 << 31), (1 << 31) - 1
    x_max, x_min = -1, (1 << 63) - 1
    for e in edges:
        x1 = e.x + (e.y1 - e.y0) * e.dx
        y_min, y_max = min(y_min, e.y0), max(y_max, e.y1)
        x_min, x_max = min(x_min, e.x, x1), max(x_max, e.x, x1)
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << _XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_Edge(y0=(1 << 31) - 1))
    tmp = _Edge()
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    for y in range(e.y0, y_max):
        draw = False
        prelast, last = tmp, tmp.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next          # the edge ends: drop it
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:                       # the edge starts: insert it
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    # the left end rounds up, the right end down
                    if keep_prelast.x > prelast.x:
                        x1, x2 = prelast.x + _CEIL >> _XY_SHIFT, keep_prelast.x >> _XY_SHIFT
                    else:
                        x1, x2 = keep_prelast.x + _CEIL >> _XY_SHIFT, prelast.x >> _XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = color
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble sort of the active list by x
        keep_prelast = None
        while True:
            prelast, last = tmp, tmp.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is tmp.next or keep_prelast is tmp:
                break


def paint_uv_mask(uvs: np.ndarray, faces: np.ndarray, size: int = 256) -> np.ndarray:
    """Scalp faces painted into the UV chart -> uint8 mask (the dif_mask
    contract; uvs in [-1, 1] like the NeuralHaircut uv map)."""
    img = np.zeros((size, size), np.uint8)
    pts = size / 2.0 * (uvs + 1.0)
    for f in faces:
        poly = pts[f].astype(np.int32)
        fill_poly(img, poly[:, ::-1], 255)
    return np.flip(img.T, axis=0).copy()


# FLAME scalp left/right symmetry groups, indices into the canonical
# NeuralHaircut scalp-vertex ordering (extract_non_visible_head_scalp.py:
# 178-200): a group is hair-covered if any member is, so the cut stays
# symmetric under one-sided occlusion.
_SCALP_SYM_ROWS = [
    ([327, 304, 286, 264, 247, 235], [94, 114, 140, 156, 184, 201]),
    ([236, 251, 271, 294, 309, 329], [197, 179, 155, 138, 112, 92]),
    ([336, 315, 298, 277, 253, 237], [87, 111, 136, 154, 171, 194]),
    ([238, 255, 284, 301, 324, 343], [191, 165, 152, 125, 108, 84]),
    ([354, 330, 305, 285, 258, 239], [79, 99, 118, 144, 159, 189]),
]
_SCALP_SYM_PAIRS = (
    [414, 419, 425, 426, 422, 424, 421,
     412, 417, 428, 433, 434, 429, 420, 410, 402,
     403, 409, 415, 432, 437, 435, 423, 411, 398, 393, 387],
    [17, 15, 12, 10, 13, 8, 5,
     19, 16, 9, 3, 4, 11, 18, 23, 31,
     27, 24, 20, 7, 0, 1, 22, 28, 36, 43, 47],
)


def _apply_scalp_symmetry(hair_mask_scalp: np.ndarray) -> np.ndarray:
    """hair_mask_scalp [N_scalp] bool in canonical scalp-vertex order."""
    m = hair_mask_scalp.copy()
    n = len(m)
    for left, right in _SCALP_SYM_ROWS:
        idx = [i for i in left + right if i < n]
        if idx:
            m[idx] = m[idx].any()
    li = [i for i in _SCALP_SYM_PAIRS[0] if i < n]
    ri = [i for i in _SCALP_SYM_PAIRS[1] if i < n]
    for i, j in zip(li, ri):
        m[i] = m[j] = m[i] | m[j]
    return m


def dilated_mask(path: str, device) -> np.ndarray:
    """``cv2.dilate(cv2.imread(path, 0), ones((5, 5))) / 255 >= 0.5``."""
    gray = torch.as_tensor(imread_gray(path), dtype=torch.float32, device=device)
    return (F.max_pool2d(gray[None, None], 5, 1, 2)[0, 0] / 255.0 >= 0.5).cpu().numpy()


def view_pixels(verts: np.ndarray, full_proj: np.ndarray, width: int, height: int):
    """Pixel positions and depths of the head's vertices under a row-vector
    full projection (the cameras/{iter}_matrices.pkl contract), in NDC
    depth order."""
    v_hom = np.concatenate([verts, np.ones((len(verts), 1))], 1)
    clip = v_hom @ np.asarray(full_proj)
    wc = np.maximum(clip[:, 3:4], 1e-9)
    ndc = clip[:, :3] / wc
    pix = np.stack([((ndc[:, 0] + 1) * width - 1) / 2,
                    ((ndc[:, 1] + 1) * height - 1) / 2], -1)
    return pix, wc[:, 0]


def extract_scalp(flame_mesh_dir: str, data_dir: str, cams_matrices: dict,
                  masks_dir: str = "masks_2", prob_thr: float = 0.9,
                  n_views_thr: float = 0.2, scalp_topology_dir: str | None = None,
                  device=None) -> None:
    """The scalp stage (extract_non_visible_head_scalp.py:96-243); runs on
    CUDA unless ``device="cpu"`` is passed.

    cams_matrices: image_name -> full projection matrix [4, 4] (row-vector,
    the cameras/{iter}_matrices.pkl contract).  Writes
    flame_mesh_dir/scalp_data/{scalp.obj, cut_scalp_verts.pickle,
    dif_mask.png}."""
    device = resolve_device(device)
    head = mesh_util.load_obj(os.path.join(flame_mesh_dir, "stage_3", "mesh_final.obj"))
    vis_total = np.zeros(len(head.verts))
    vis_head_total = np.zeros(len(head.verts))
    n_views = 0
    for name, full_proj in cams_matrices.items():
        hair_p = os.path.join(data_dir, masks_dir, "hair", f"{name}.png")
        body_p = os.path.join(data_dir, masks_dir, "body", f"{name}.png")
        if not (os.path.exists(hair_p) and os.path.exists(body_p)):
            continue
        hair = dilated_mask(hair_p, device)
        head_mask = dilated_mask(body_p, device) & ~hair
        h, w = head_mask.shape
        pix, depth = view_pixels(head.verts, full_proj, w, h)
        p2f = rasterize_pix_to_face(pix, depth, head.faces, w, h, device)
        vis = np.zeros(len(head.verts), bool)
        vis_h = np.zeros(len(head.verts), bool)
        vis[head.faces[np.unique(p2f[p2f >= 0])].reshape(-1)] = True
        p2f_head = np.where(head_mask, p2f, -1)
        vis_h[head.faces[np.unique(p2f_head[p2f_head >= 0])].reshape(-1)] = True
        vis_total += vis
        vis_head_total += vis_h
        n_views += 1
    if n_views == 0:
        raise FileNotFoundError("no usable views/masks for scalp extraction")

    prob_hair = 1 - vis_head_total / np.maximum(vis_total, 1)
    scalp_vert_mask = (prob_hair > prob_thr) | (vis_total / n_views < n_views_thr)

    # the canonical scalp restriction (NeuralHaircut topology files)
    uvs = canonical_ids = None
    if scalp_topology_dir and os.path.exists(
            os.path.join(scalp_topology_dir, "new_scalp_vertex_idx.npy")):
        canonical_ids = np.asarray(np.load(os.path.join(
            scalp_topology_dir, "new_scalp_vertex_idx.npy")), np.int64)
        canonical = np.zeros(len(head.verts), bool)
        canonical[canonical_ids] = True
        scalp_vert_mask[canonical_ids] = _apply_scalp_symmetry(scalp_vert_mask[canonical_ids])
        scalp_vert_mask &= canonical
        uv_path = os.path.join(scalp_topology_dir, "scalp_uvmap.npy")
        if os.path.exists(uv_path):
            uvs = np.load(uv_path)

    sub_faces = head.faces[scalp_vert_mask[head.faces].all(axis=1)]
    used = np.unique(sub_faces)
    remap = -np.ones(len(head.verts), np.int64)
    remap[used] = np.arange(len(used))
    scalp_verts = head.verts[used]
    scalp_faces = remap[sub_faces]
    if uvs is not None:
        # scalp_uvmap.npy rows follow the canonical scalp-vertex order
        # (row k <-> new_scalp_vertex_idx[k], values in [-1, 1])
        row_of = -np.ones(len(head.verts), np.int64)
        row_of[canonical_ids] = np.arange(len(canonical_ids))
        uvs = np.asarray(uvs, np.float64)[row_of[used]]
    else:
        # a spherical parameterization of the cut region
        d = scalp_verts - scalp_verts.mean(0)
        d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
        uvs = np.stack([np.arctan2(d[:, 0], d[:, 2]) / np.pi, d[:, 1]], -1)

    out = os.path.join(flame_mesh_dir, "scalp_data")
    os.makedirs(out, exist_ok=True)
    mesh_util.save_obj(os.path.join(out, "scalp.obj"), scalp_verts, scalp_faces,
                       (uvs + 1) / 2, scalp_faces)
    with open(os.path.join(out, "cut_scalp_verts.pickle"), "wb") as f:
        pickle.dump(used.tolist(), f)
    write_png(os.path.join(out, "dif_mask.png"), paint_uv_mask(uvs, scalp_faces), like_pil=True)
