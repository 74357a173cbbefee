"""Parity of the port's scalp extraction with the JAX package
(``preprocessing/scalp.py``), without OpenCV and PIL in the port:

- ``rasterize_pix_to_face`` (the device z-buffer, run here on the CPU)
  equals the numpy loop it replaces (``rasterize_pix_to_face_plain``, the
  JAX package's) on a UV sphere seen from several cameras and on random
  triangle soups with shared depths, where the loop's float32 depth buffer
  decides near-ties;
- ``fill_poly`` / ``paint_uv_mask`` are byte-equal to ``cv2.fillPoly`` and
  to the JAX function (which calls cv2) on random, degenerate and collinear
  triangles with vertices on the image, and ``fill_poly`` on random
  polygons with vertices up to two pixels past every border (a uv of
  exactly +1 maps one pixel past the image);
- ``extract_scalp`` on the JAX test's UV-sphere scene
  (tests/test_preprocessing.py:112-200), with and without the canonical
  topology files: ``scalp.obj``, ``cut_scalp_verts.pickle`` and
  ``dif_mask.png`` equal to the JAX ones byte for byte, read back by both
  packages' ``ScalpPool.from_flame_dir``;
- ``write_png(..., like_pil=True)`` is byte-equal to PIL's ``Image.save``
  and reads back, and ``save_obj`` with UVs equals the JAX package's."""
import filecmp
import io
import math
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from gaussianhaircut_tpu.models import textured_strands as jts
from gaussianhaircut_tpu.preprocessing import scalp as j_scalp
from gaussianhaircut_tpu.utils import mesh as j_mesh
from gaussianhaircut_torch.models import textured_strands as tts
from gaussianhaircut_torch.preprocessing import scalp as t_scalp
from gaussianhaircut_torch.utils import mesh as t_mesh
from gaussianhaircut_torch.utils.image import read_png, write_png


def uv_sphere(rings=12, segs=16):
    """The JAX test's UV sphere (tests/test_preprocessing.py:130-147)."""
    verts, faces = [], []
    for r in range(rings + 1):
        th = math.pi * r / rings
        for s in range(segs):
            ph = 2 * math.pi * s / segs
            verts.append([math.sin(th) * math.cos(ph), math.cos(th), math.sin(th) * math.sin(ph)])
    for r in range(rings):
        for s in range(segs):
            a, b = r * segs + s, r * segs + (s + 1) % segs
            c, d = (r + 1) * segs + s, (r + 1) * segs + (s + 1) % segs
            faces += [[a, b, c], [b, d, c]]
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def ring_projections(n=4, fov_deg=45.0):
    """Row-vector full projections of n cameras on a ring of radius 3
    (the JAX test's cameras)."""
    t = 1.0 / math.tan(math.radians(fov_deg) / 2)
    near, far = 0.1, 10.0
    out = {}
    for i in range(n):
        a = 2 * math.pi * i / n
        center = np.array([3.0 * math.sin(a), 0.4, 3.0 * math.cos(a)])
        fwd = -center / np.linalg.norm(center)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        w2c = np.eye(4)
        w2c[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 0)
        w2c[:3, 3] = -w2c[:3, :3] @ center
        proj = np.zeros((4, 4))
        proj[0, 0] = proj[1, 1] = t
        proj[2, 2] = far / (far - near)
        proj[2, 3] = -far * near / (far - near)
        proj[3, 2] = 1.0
        out[f"{i:04d}"] = (proj @ w2c).T
    return out


def test_pix_to_face_on_the_sphere():
    verts, faces = uv_sphere(24, 32)
    for full in ring_projections(6).values():
        pix, depth = t_scalp.view_pixels(verts, full, 96, 80)
        ref = t_scalp.rasterize_pix_to_face_plain(pix, depth, faces, 96, 80)
        np.testing.assert_array_equal(
            t_scalp.rasterize_pix_to_face(pix, depth, faces, 96, 80, device="cpu"), ref)
        assert (ref >= 0).mean() > 0.2


@pytest.mark.parametrize("seed", range(6))
def test_pix_to_face_on_triangle_soups(seed):
    """Faces overlapping at shared depths (a plane, a few levels) and at
    random ones, some vertices on pixel centres, some behind the camera."""
    rng = np.random.default_rng(seed)
    w, h = 40 + 3 * seed, 36
    for case in range(8):
        nf = 60
        pix = rng.uniform(-5, 45, (3 * nf, 2))
        if case % 2:
            pix = np.round(pix)
        depth = (np.full(3 * nf, 1.7) if case < 3 else rng.choice([0.5, 1.0, 2.0], 3 * nf)
                 if case < 6 else rng.uniform(-0.5, 3.0, 3 * nf))
        faces = (np.arange(3 * nf).reshape(nf, 3) if case % 3 else
                 rng.integers(0, 3 * nf, (nf, 3)))
        ref = t_scalp.rasterize_pix_to_face_plain(pix, depth, faces, w, h)
        got = t_scalp.rasterize_pix_to_face(pix, depth, faces, w, h, device="cpu")
        np.testing.assert_array_equal(got, ref, err_msg=f"case {case}")


def test_fill_poly_matches_cv2():
    """Random, degenerate (repeated vertices), collinear and concave
    polygons with vertices on the image, the borders included."""
    rng = np.random.default_rng(0)
    for t in range(1500):
        size = int(rng.integers(4, 40))
        kind = t % 4
        if kind == 0:
            pts = rng.integers(0, size, (3, 2))
        elif kind == 1:
            a, d = rng.integers(0, size, 2), rng.integers(-5, 6, 2)
            pts = np.clip(np.stack([a, a + d, a + 2 * d]), 0, size - 1)
        elif kind == 2:
            a = rng.integers(0, size, 2)
            pts = np.stack([a, a, rng.integers(0, size, 2)])
        else:
            pts = rng.integers(0, size, (int(rng.integers(3, 7)), 2))
        pts = pts.astype(np.int32)
        ref = np.zeros((size, size), np.uint8)
        cv2.fillPoly(ref, [pts], 255)
        got = np.zeros((size, size), np.uint8)
        t_scalp.fill_poly(got, pts, 255)
        np.testing.assert_array_equal(got, ref, err_msg=f"{size} {pts.tolist()}")


def test_fill_poly_matches_cv2_past_the_border():
    """200 random polygons on non-square images with vertices up to two
    pixels past every border, where cv2 5 builds a clipped edge from the
    clipped line's columns (and the edge's own rows when the clipped line
    is horizontal)."""
    rng = np.random.default_rng(1)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(3, 40, 2))
        n = int(rng.integers(3, 8))
        pts = np.stack([rng.integers(-2, w + 2, n), rng.integers(-2, h + 2, n)],
                       1).astype(np.int32)
        ref = np.zeros((h, w), np.uint8)
        cv2.fillPoly(ref, [pts], 255)
        got = np.zeros((h, w), np.uint8)
        t_scalp.fill_poly(got, pts, 255)
        np.testing.assert_array_equal(got, ref, err_msg=f"{h}x{w} {pts.tolist()}")


def test_paint_uv_mask_matches_jax():
    rng = np.random.default_rng(1)
    for t in range(40):
        nv = int(rng.integers(3, 200))
        uv = rng.uniform(-1, 1, (nv, 2))
        uv[rng.integers(0, nv, 5)] = -1.0              # the chart's first row / column
        faces = rng.integers(0, nv, (int(rng.integers(1, 300)), 3))
        faces[:5, 1] = faces[:5, 0]                    # degenerate triangles
        np.testing.assert_array_equal(t_scalp.paint_uv_mask(uv, faces),
                                      j_scalp.paint_uv_mask(uv, faces))


def _scalp_scene(root, topology: bool, partial_hair: bool):
    """The JAX test's scene under ``root``: the UV sphere as the FLAME fit,
    four ring views with gray masks written by cv2, and optionally the
    canonical topology (the top cap, in scrambled order, planar UVs)."""
    verts, faces = uv_sphere()
    flame = os.path.join(root, "flame_fitting")
    os.makedirs(os.path.join(flame, "stage_3"))
    j_mesh.save_obj(os.path.join(flame, "stage_3", "mesh_final.obj"), verts, faces)
    topo = None
    if topology:
        ids = np.nonzero(verts[:, 1] > 0.55)[0].astype(np.int64)
        ids = ids[np.argsort(-verts[ids, 0])]
        topo = os.path.join(root, "topology")
        os.makedirs(topo)
        np.save(os.path.join(topo, "new_scalp_vertex_idx.npy"), ids)
        np.save(os.path.join(topo, "scalp_uvmap.npy"), np.stack([verts[ids, 0], verts[ids, 2]], -1))
    data = os.path.join(root, "data")
    for sub in ("hair", "body"):
        os.makedirs(os.path.join(data, "masks_2", sub))
    cams = ring_projections()
    for name in cams:
        hair = np.full((96, 96), 255, np.uint8)
        if partial_hair:
            hair[48:] = 0
        cv2.imwrite(os.path.join(data, "masks_2", "hair", f"{name}.png"), hair)
        cv2.imwrite(os.path.join(data, "masks_2", "body", f"{name}.png"),
                    np.full((96, 96), 255, np.uint8))
    return flame, data, cams, topo


@pytest.mark.parametrize("topology", [True, False], ids=["canonical", "spherical_uv"])
def test_extract_scalp_matches_jax(tmp_path, topology):
    outs = {}
    for pkg, fn in (("jax", j_scalp.extract_scalp), ("port", t_scalp.extract_scalp)):
        flame, data, cams, topo = _scalp_scene(str(tmp_path / pkg), topology,
                                               partial_hair=not topology)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        fn(flame, data, cams, scalp_topology_dir=topo, **kw)
        outs[pkg] = flame
    for f in ("scalp.obj", "cut_scalp_verts.pickle", "dif_mask.png"):
        assert filecmp.cmp(os.path.join(outs["jax"], "scalp_data", f),
                           os.path.join(outs["port"], "scalp_data", f), shallow=False), f
    cut = t_mesh.load_obj(os.path.join(outs["port"], "scalp_data", "scalp.obj"))
    assert len(cut.faces) > 0 and cut.uvs is not None
    # both packages' scalp pools read the port's files alike
    cfg = dict(pool_size=300)
    tpool = tts.ScalpPool.from_flame_dir(outs["port"], "", tts.TexturedStrandsConfig(**cfg))
    jpool = jts.ScalpPool.from_flame_dir(outs["port"], "", jts.TexturedStrandsConfig(**cfg))
    for a, b in zip(tpool, jpool):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_write_png_is_pils(tmp_path):
    rng = np.random.default_rng(2)
    for shape in [(1, 1), (7, 1), (64, 64), (33, 17, 2), (40, 60, 3), (31, 45, 4), (300, 260, 3)]:
        for img in (rng.integers(0, 256, shape), (rng.random(shape) > 0.5) * 255,
                    rng.integers(0, 4, shape) * 60):
            img = img.astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            write_png(str(tmp_path / "x.png"), img, like_pil=True)
            assert (tmp_path / "x.png").read_bytes() == buf.getvalue(), shape
            np.testing.assert_array_equal(read_png(str(tmp_path / "x.png")), img)


def test_save_obj_with_uvs_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    verts, faces = uv_sphere(4, 6)
    uvs = rng.uniform(size=(len(verts), 2))
    j_mesh.save_obj(str(tmp_path / "j.obj"), verts, faces, uvs, faces)
    t_mesh.save_obj(str(tmp_path / "t.obj"), verts, faces, uvs, faces)
    assert filecmp.cmp(tmp_path / "j.obj", tmp_path / "t.obj", shallow=False)
    back = t_mesh.load_obj(str(tmp_path / "t.obj"))
    np.testing.assert_array_equal(back.face_uvs, faces)
