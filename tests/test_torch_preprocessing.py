"""Parity of the port's preprocessing with the JAX package's on the CPU
(the same seeded numpy inputs through both):

- ``iqa``: ``mscn_iqa`` at rtol 1e-6; the 224x224 bilinear resize within
  1 level of ``cv2.resize``; ``CnnScorer`` at rtol 1e-4 with weights from
  the converter's initialiser (JAX "SAME" stride-2 padding at even and odd
  sizes);
- ``frames``: ``sharpness_iqa`` against cv2 at rtol 1e-5; OpenCV's PNG
  reads (``imread(p)``, ``imread(p, 0)``) exactly; ``filter_extra_images``
  keeps and deletes the same files;
- ``scene_tools``: ``resize_images`` equal to PIL's LANCZOS byte for byte
  in L / LA / RGB / RGBA; ``robust_sphere_fit`` and ``scale.pickle`` within
  atol 1e-6 and the same alive set in ``point_cloud_cropped`` (each tier of
  the selection cascade); ``mesh_sdf_sign`` equal on points at least 1e-6
  from the surface; ``filter_flame_intersections`` keeps the same set;
  ``colmap_to_h3ds`` writes the same ``cameras.npz`` and point cloud;
- ``orientation_maps``: the DoG image within atol 1e-5 (an image smaller
  than the 81-tap window), |response| within rtol 1e-4, degrees equal where
  the top two responses differ by more than 1e-4 relative, the variance
  within atol 1e-4 there; the CLIs' files."""
import os
import pickle
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussianhaircut_tpu.preprocessing import frames as j_frames
from gaussianhaircut_tpu.preprocessing import iqa as j_iqa
from gaussianhaircut_tpu.preprocessing import orientation_maps as j_om
from gaussianhaircut_tpu.preprocessing import scene_tools as j_st
from gaussianhaircut_tpu.scene import ply as j_ply
from gaussianhaircut_tpu.utils import mesh as j_mesh
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.preprocessing import frames, iqa, orientation_maps, scene_tools
from gaussianhaircut_torch.scene.synthetic import (
    bench_scene, sphere_mesh, toy_views, write_pipeline_scene)
from gaussianhaircut_torch.utils import mesh as mesh_util
from tools.convert_hyperiqa import init_params


def _photo(rng, h, w):
    """A smooth textured RGB image with noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.3 * np.sin(0.21 * xx + 0.13 * yy) * np.cos(0.07 * yy) + 0.2 * ((xx + yy) > w)
    img = np.stack([base, base * 0.7 + 0.1, 1 - base], -1) + rng.normal(0, 0.05, (h, w, 3))
    return np.clip(img * 255, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ iqa ----

def test_mscn_iqa_matches_jax(rng):
    for shape in ((40, 56), (97, 64), (15, 40)):
        img = _photo(rng, *shape)
        np.testing.assert_allclose(iqa.mscn_iqa(img), j_iqa.mscn_iqa(img), rtol=1e-6)


@pytest.mark.parametrize("shape", [(120, 90), (300, 500), (448, 448), (50, 61), (224, 224)])
def test_bilinear_224_within_one_level_of_cv2(rng, shape):
    img = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    got = iqa._resize_bilinear(img, 224, 224).astype(int)
    assert np.abs(got - cv2.resize(img, (224, 224)).astype(int)).max() <= 1


def test_cnn_scorer_matches_jax(rng, tmp_path):
    blob = init_params(jax.random.PRNGKey(0))
    blob["kind"] = np.asarray("distilled-hyperiqa")
    path = str(tmp_path / "iqa.npz")
    np.savez(path, **blob)
    ref = j_iqa.CnnScorer(path)
    ours = iqa.CnnScorer(path, device="cpu")
    assert ours.kind == "distilled-hyperiqa"
    img = _photo(rng, 224, 224)            # the resize is a copy at 224
    np.testing.assert_allclose(ours.score(img), ref(img), rtol=1e-4)
    for h, w in ((224, 224), (37, 50)):    # even sizes pad (0, 1), odd (1, 1)
        x = rng.uniform(size=(2, h, w, 3)).astype(np.float32)
        with torch.no_grad():
            got = ours(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(ref._fn(ref.params, jnp.asarray(x))),
                                   rtol=1e-4, atol=1e-7)


# --------------------------------------------------------------- frames ----

def test_sharpness_iqa_matches_cv2(rng):
    for shape in ((40, 56), (97, 64), (128, 200)):
        img = _photo(rng, *shape)
        np.testing.assert_allclose(frames.sharpness_iqa(img), j_frames.sharpness_iqa(img),
                                   rtol=1e-5)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reads_match_opencv(rng, tmp_path, mode):
    """``imread(p)`` drops alpha and replicates gray; ``imread(p, 0)``
    turns colour into gray with libpng's truncated fixed-point weights."""
    shape = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}[mode]
    img = rng.integers(0, 256, (33, 47) + shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(img, mode).save(path)
    np.testing.assert_array_equal(frames.imread_gray(path), cv2.imread(path, 0))
    np.testing.assert_array_equal(frames.imread_rgb(path),
                                  cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB))


def _frames_scene(rng, root):
    """Nine frames: sharp, blurred and noisy ones; RGB masks whose gray
    values sit at the 127 threshold; two frames with the hair on the face."""
    for sub in ("images", "masks/hair", "masks/face", "masks/body"):
        os.makedirs(os.path.join(root, sub))
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(9):
        img = _photo(rng, h, w)
        if i % 3 == 1:
            img = cv2.GaussianBlur(img, (7, 7), 2)
        name = f"{i:06d}.png"
        Image.fromarray(img).save(os.path.join(root, "images", name))
        disc = (xx - 20 - 2 * i) ** 2 + (yy - 20) ** 2 < 144
        # libpng's truncated weights make (130, 128, 126) gray 128 and
        # (126, 128, 129) gray 127 (127.5: rounding would give 128)
        hair = np.where(disc[..., None], [130, 128, 126], [126, 128, 129]).astype(np.uint8)
        face = np.zeros((h, w, 3), np.uint8)
        if i in (4, 7):
            face[disc] = 255
        Image.fromarray(hair).save(os.path.join(root, "masks/hair", name))
        Image.fromarray(face).save(os.path.join(root, "masks/face", name))
        Image.fromarray(np.full((h, w), 255, np.uint8)).save(
            os.path.join(root, "masks/body", name))


@pytest.mark.parametrize("max_imgs", [3, 5, 128])
def test_filter_extra_images_matches_jax(rng, tmp_path, max_imgs):
    src = str(tmp_path / "src")
    _frames_scene(rng, src)
    shutil.copytree(src, str(tmp_path / "jax"))
    shutil.copytree(src, str(tmp_path / "port"))
    ref = j_frames.filter_extra_images(str(tmp_path / "jax"), max_imgs=max_imgs)
    got = frames.filter_extra_images(str(tmp_path / "port"), max_imgs=max_imgs, device="cpu")
    assert got == ref and len(got) <= min(max_imgs, 7)
    for sub in ("images", "masks/hair", "masks/face", "masks/body"):
        assert (sorted(os.listdir(tmp_path / "port" / sub))
                == sorted(os.listdir(tmp_path / "jax" / sub)))


# ----------------------------------------------------------- scene_tools ----

def test_resize_images_matches_pil(rng, tmp_path):
    """images_2/_4 and masks_2/_4 (nested) equal PIL's LANCZOS resize and
    mode in L, LA, RGB and RGBA, at odd and even sizes."""
    root = tmp_path / "src"
    (root / "images").mkdir(parents=True)
    (root / "masks" / "hair").mkdir(parents=True)
    for i, (mode, shape) in enumerate((("RGB", (3,)), ("RGBA", (4,)), ("L", ()),
                                       ("LA", (2,)))):
        img = rng.integers(0, 256, (45 + i, 67 + 2 * i) + shape).astype(np.uint8)
        img[..., :] = np.minimum(img, 255 - 40 * (i % 2))          # some alpha < 255
        Image.fromarray(img, mode).save(root / "images" / f"{i}.png")
        Image.fromarray(img, mode).save(root / "masks" / "hair" / f"{i}.png")
    shutil.copytree(root, tmp_path / "jax")
    shutil.copytree(root, tmp_path / "port")
    j_st.resize_images(str(tmp_path / "jax"))
    scene_tools.resize_images(str(tmp_path / "port"), device="cpu")
    n = 0
    for sub in ("images_2", "images_4", "masks_2/hair", "masks_4/hair"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names
        for name in names:
            with Image.open(tmp_path / "jax" / sub / name) as a, \
                    Image.open(tmp_path / "port" / sub / name) as b:
                assert a.mode == b.mode and a.size == b.size
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
                n += 1
    assert n == 16


def _stage1_model(rng, model, n=600, iteration=7, tier=0):
    """A stage-1 PLY of ``n`` Gaussians (the blob of the bench scene with
    hair rows near the scalp cap): ``tier`` 0 has confident hair, 1 hair
    labels with low opacity, 2 no hair label at all."""
    xyz = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    hair = np.arange(n) < n // 3
    xyz[hair] = (np.array([0.0, 0.12, 0.0]) + rng.normal(scale=0.06, size=(hair.sum(), 3)))
    label = np.where(hair, 3.0, -3.0) if tier < 2 else np.full(n, -3.0)
    opacity = np.where(hair, 2.0 if tier == 0 else -2.0, rng.normal(size=n))
    k = 16
    params = {"xyz": xyz, "features_dc": rng.normal(size=(n, 1, 3)),
              "features_rest": 0.1 * rng.normal(size=(n, k - 1, 3)),
              "scaling": np.log(rng.uniform(0.005, 0.03, size=(n, 3))),
              "rotation": rng.normal(size=(n, 4)), "opacity": opacity[:, None],
              "label": label[:, None], "orient_conf": rng.normal(size=(n, 1)),
              "viewspace": np.zeros((n, 3))}
    zero = np.zeros(n)
    aux = {"alive": rng.uniform(size=n) > 0.05, "max_radii2d": zero,
           "xyz_grad_accum": zero, "denom": zero}
    state = gm.state_from_numpy(params, aux, 3, 3, 1.0, "cpu")
    out = os.path.join(model, "point_cloud", f"iteration_{iteration}")
    os.makedirs(out)
    gm.save_ply(state, os.path.join(out, "point_cloud.ply"))


def _ply_rows(path):
    v = j_ply.read_ply(str(path))["vertex"]
    return np.stack([v[name] for name in v.dtype.names], -1)


def test_robust_sphere_fit_matches_jax(rng):
    for pts in (rng.normal(size=(500, 3)).astype(np.float32),
                np.concatenate([rng.normal(scale=0.1, size=(300, 3)),
                                rng.normal(scale=5.0, size=(20, 3))]).astype(np.float32)):
        tr, s = scene_tools.robust_sphere_fit(pts)
        tr_j, s_j = j_st.robust_sphere_fit(pts)
        np.testing.assert_allclose(tr, tr_j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(s, s_j, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        scene_tools.robust_sphere_fit(np.zeros((0, 3)))


@pytest.mark.parametrize("tier", [0, 1, 2])
def test_scale_scene_into_sphere_matches_jax(rng, tmp_path, tier):
    _stage1_model(rng, str(tmp_path / "model"), tier=tier)
    for pkg in ("jax", "port"):
        shutil.copytree(tmp_path / "model", tmp_path / pkg / "model")
    ref = j_st.scale_scene_into_sphere(str(tmp_path / "jax/model"), str(tmp_path / "jax"), 7)
    got = scene_tools.scale_scene_into_sphere(str(tmp_path / "port/model"),
                                              str(tmp_path / "port"), 7, device="cpu")
    assert got.pop("tier") == tier
    for d in (got, ref):
        with open(tmp_path / ("port" if d is got else "jax") / "scale.pickle", "rb") as f:
            assert pickle.load(f) == d
    np.testing.assert_allclose(got["scale"], ref["scale"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["translation"], ref["translation"], rtol=0, atol=1e-6)
    for name in ("point_cloud.ply", "raw_point_cloud.ply"):
        sub = f"model/point_cloud_cropped/iteration_7/{name}"
        a, b = _ply_rows(tmp_path / "port" / sub), _ply_rows(tmp_path / "jax" / sub)
        assert 0 < len(a) < 600 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _off_surface(rng, n, center, radius, margin=2e-3):
    """Points in a box around the sphere, none within ``margin`` of its
    radius (a 29 x 36 polyhedron of radius 0.1 lies within 6e-4 of the
    sphere, so every point is at least 1e-6 from the surface)."""
    pts = rng.uniform(-2.5 * radius, 2.5 * radius, size=(4 * n, 3)) + center
    r = np.linalg.norm(pts - center, axis=1)
    return pts[np.abs(r - radius) > margin][:n]


def test_mesh_sdf_sign_matches_jax(rng, monkeypatch):
    """A sphere head (2,016 faces) and an open cap of it, chunked small:
    the port's float64 winding number decides as the JAX numpy one on
    points away from the surface (inside and outside both present)."""
    center = np.array([0.0, 0.05, 0.0])
    head = sphere_mesh(center, 0.1, n_lat=29, n_lon=36)
    cap = j_mesh.Mesh(head.verts, head.faces[:700], None, None)
    pts = _off_surface(rng, 1000, center, 0.1, margin=1e-3)
    monkeypatch.setattr(scene_tools, "CHUNK_TERMS", 1 << 20)
    for mesh in (head, cap):
        ref = j_st.mesh_sdf_sign(pts, mesh)
        got = scene_tools.mesh_sdf_sign(pts, mesh, device="cpu")
        assert got.dtype == bool and 0 < ref.sum() < len(pts) or mesh is cap
        np.testing.assert_array_equal(got, ref)
    wn = scene_tools.winding_numbers(torch.as_tensor(pts, dtype=torch.float32), head, "cpu")
    assert wn.dtype == torch.float64


def test_filter_flame_intersections_matches_jax(rng, tmp_path):
    _stage1_model(rng, str(tmp_path / "model"), n=300)
    head = sphere_mesh((0.0, 0.05, 0.0), 0.1, n_lat=16, n_lon=20)
    mesh_util.save_obj(str(tmp_path / "head.obj"), head.verts, head.faces)
    for pkg in ("jax", "port"):
        shutil.copytree(tmp_path / "model", tmp_path / pkg)
    j_st.filter_flame_intersections(str(tmp_path / "jax"), str(tmp_path / "head.obj"), 7)
    dropped = scene_tools.filter_flame_intersections(str(tmp_path / "port"),
                                                     str(tmp_path / "head.obj"), 7,
                                                     device="cpu")
    sub = "point_cloud_filtered/iteration_7/raw_point_cloud.ply"
    a, b = _ply_rows(tmp_path / "port" / sub), _ply_rows(tmp_path / "jax" / sub)
    n_alive = len(_ply_rows(tmp_path / "model/point_cloud/iteration_7/raw_point_cloud.ply"))
    assert dropped > 0 and len(a) == n_alive - dropped
    np.testing.assert_array_equal(a, b)


def test_colmap_to_h3ds_matches_jax(tmp_path):
    sc = bench_scene(300, 40, 32, 3, seed=4)
    root = tmp_path / "scene"
    write_pipeline_scene(str(root), sc.train_cameras, *toy_views(sc.train_cameras),
                         sc.points, sc.colors)
    scene_tools.resize_images(str(root), device="cpu")
    shutil.copytree(root, tmp_path / "jax")
    j_st.colmap_to_h3ds(str(tmp_path / "jax"))
    scene_tools.colmap_to_h3ds(str(root))
    with np.load(root / "cameras.npz") as a, np.load(tmp_path / "jax" / "cameras.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 6
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(_ply_rows(root / "point_cloud.ply"),
                                  _ply_rows(tmp_path / "jax" / "point_cloud.ply"))


# ------------------------------------------------------ orientation maps ----

def test_difference_of_gaussians_matches_jax(rng):
    """An image smaller than the 81-tap window: the symmetric pad wraps
    more than once."""
    gray = rng.uniform(size=(30, 45)).astype(np.float32)
    ref = np.asarray(j_om.difference_of_gaussians(jnp.asarray(gray), 0.4, 10.0))
    got = orientation_maps.difference_of_gaussians(torch.from_numpy(gray), 0.4, 10.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def _jax_responses(filt_j):
    """|Gabor responses| [180, H, W] of JAX's filtered image through
    ``lax.conv``, and the clear pixels: where the top two responses differ
    by more than 1e-4 relative."""
    bank, _ = orientation_maps.build_gabor_bank(180)
    pad = bank.shape[-1] // 2
    resp_j = np.abs(np.asarray(jax.lax.conv_general_dilated(
        jnp.pad(jnp.asarray(filt_j), pad)[None, None], jnp.asarray(bank)[:, None], (1, 1),
        "VALID", dimension_numbers=("NCHW", "OIHW", "NCHW"))[0]))
    top2 = np.sort(resp_j, axis=0)[-2:]
    return resp_j, (top2[1] - top2[0]) > 1e-4 * top2[1]


def test_orientation_map_matches_jax(rng):
    img = _photo(rng, 70, 90)
    deg_j, var_j, filt_j = j_om.calc_orientation_map(img)
    deg, var, filt = orientation_maps.calc_orientation_map(img, device="cpu")
    np.testing.assert_allclose(filt, filt_j, rtol=0, atol=1e-5)
    resp_j, clear = _jax_responses(filt_j)
    bank, _ = orientation_maps.build_gabor_bank(180)
    resp = orientation_maps.gabor_responses(torch.tensor(filt_j), torch.from_numpy(bank))
    np.testing.assert_allclose(resp.numpy(), resp_j, rtol=1e-4, atol=1e-4 * resp_j.max())
    assert clear.mean() > 0.8 and deg.dtype == np.uint8 and deg.max() < 180
    np.testing.assert_array_equal(deg[clear], deg_j[clear])
    np.testing.assert_allclose(var[clear], var_j[clear], rtol=0, atol=1e-4)


def test_orientation_cli_matches_jax(rng, tmp_path):
    """Both CLIs on two images with masks: the same files; on the clear
    pixels (``_jax_responses``) angle PNGs equal, variances within 1e-4
    and float16 rounding and vis PNGs within 1 level; the filtered PNGs
    within 1 level everywhere."""
    for sub in ("img", "mask"):
        (tmp_path / sub).mkdir()
    clear = {}
    for i in range(2):
        img = _photo(rng, 40, 52)
        Image.fromarray(img).save(tmp_path / "img" / f"{i}.png")
        Image.fromarray((rng.uniform(size=(40, 52)) > 0.5).astype(np.uint8) * 255).save(
            tmp_path / "mask" / f"{i}.png")
        clear[f"{i}"] = _jax_responses(j_om.calc_orientation_map(img)[2])[1]
        assert clear[f"{i}"].mean() > 0.8
    outs = {}
    for pkg, main in (("jax", j_om.main), ("port", orientation_maps.main)):
        out = tmp_path / pkg
        argv = ["--img_path", str(tmp_path / "img"), "--mask_path", str(tmp_path / "mask")]
        for flag in ("orient_dir", "conf_dir", "filtered_img_dir", "vis_img_dir"):
            argv += [f"--{flag}", str(out / flag)]
        main(argv + (["--device", "cpu"] if pkg == "port" else []))
        outs[pkg] = out
    for flag in ("orient_dir", "conf_dir", "filtered_img_dir", "vis_img_dir"):
        names = sorted(os.listdir(outs["jax"] / flag))
        assert sorted(os.listdir(outs["port"] / flag)) == names and len(names) == 2
        for name in names:
            a, b = outs["port"] / flag / name, outs["jax"] / flag / name
            sel = clear[name.split(".")[0]] if flag != "filtered_img_dir" else Ellipsis
            if name.endswith(".npy"):
                x, y = np.load(a), np.load(b)
                assert x.dtype == y.dtype == np.float16
                ulp = np.spacing(np.maximum(np.abs(x), np.abs(y)))
                err = np.abs(x.astype(np.float32) - y.astype(np.float32))
                assert (err <= 1e-4 + ulp.astype(np.float32))[sel].all(), name
            else:
                x, y = np.asarray(Image.open(a)).astype(int), np.asarray(Image.open(b)).astype(int)
                assert x.shape == y.shape
                tol = 0 if flag == "orient_dir" else 1
                assert (np.abs(x - y) <= tol)[sel].all(), (flag, name)
