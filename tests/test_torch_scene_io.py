"""Parity of the port's file I/O with the JAX package: the PNG codec and the
resizes against PIL, PLY and checkpoint files across the two packages,
COLMAP files, ``load_scene`` on a tiny on-disk scene, and the camera
pickles stages 2 and 3 read."""
import math
import os
import pickle
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussianhaircut_tpu.cli import render_gaussians as j_render
from gaussianhaircut_tpu.config import ModelConfig as JModelConfig
from gaussianhaircut_tpu.models import gaussian_model as j_gm
from gaussianhaircut_tpu.scene import colmap as j_colmap
from gaussianhaircut_tpu.scene import dataset as j_dataset
from gaussianhaircut_tpu.scene import ply as j_ply
from gaussianhaircut_tpu.scene.cameras import CameraResiduals as JCameraResiduals
from gaussianhaircut_tpu.train import optim as j_optim
from gaussianhaircut_tpu.train import stage1 as j_stage1
from gaussianhaircut_torch.config import ModelConfig
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.scene import colmap, dataset
from gaussianhaircut_torch.scene.cameras import CameraBatch, CameraResiduals
from gaussianhaircut_torch.scene.synthetic import bench_scene, write_colmap_scene
from gaussianhaircut_torch.train import stage1
from gaussianhaircut_torch.utils.image import png_size, read_png, write_png

MODES = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}


def _image(rng, mode, h=37, w=53):
    """A smooth ramp plus noise, so PIL's encoder picks several filters."""
    base = np.linspace(0, 200, w)[None, :] + np.linspace(0, 50, h)[:, None]
    shape = (h, w) + MODES[mode]
    if MODES[mode]:
        base = base[..., None]
    return np.clip(base + rng.integers(0, 12, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("writer", ["pil", "port"])
@pytest.mark.parametrize("mode", list(MODES))
def test_png_read_equals_pil(tmp_path, mode, writer):
    """The reader gives PIL's decode byte for byte, for files PIL writes
    (adaptive row filters) and files the port writes."""
    img = _image(np.random.default_rng(len(mode)), mode)
    path = str(tmp_path / "x.png")
    if writer == "pil":
        Image.fromarray(img, mode=mode).save(path)
    else:
        write_png(path, img)
    with Image.open(path) as im:
        ref = np.asarray(im)
        assert png_size(path) == im.size
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


def test_png_read_undoes_every_row_filter(tmp_path):
    """Rows filtered with each of the five PNG filters in turn (encoded
    here from the PNG specification) decode to the image, as in PIL."""
    rng = np.random.default_rng(1)
    h, w, bpp = 10, 9, 3
    img = rng.integers(0, 256, (h, w, bpp)).astype(np.int32)
    pad = np.zeros((h + 1, w + 1, bpp), np.int32)
    pad[1:, 1:] = img
    rows = []
    for y in range(h):
        a, b, c = pad[y + 1, :-1], pad[y, 1:], pad[y, :-1]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ftype = y % 5
        pred = [0, a, b, (a + b) // 2, paeth][ftype]
        rows.append(bytes([ftype]) + ((img[y] - pred) % 256).astype(np.uint8).tobytes())
    chunk = lambda k, d: (struct.pack(">I", len(d)) + k + d
                          + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))
    np.testing.assert_array_equal(read_png(path), img.astype(np.uint8))
    with Image.open(path) as im:
        np.testing.assert_array_equal(read_png(path), np.asarray(im))


@pytest.mark.parametrize("size", [(32, 24), (100, 70), (21, 37), (80, 48)])
def test_resize_matches_pil(size):
    """8-bit bicubic resizes equal PIL's in all four modes: gray, gray +
    alpha, RGB and RGBA (the port follows PIL's fixed-point resample and its
    premultiplied alpha); an unchanged size is a copy; the bilinear float
    resize of orientation variances within 1e-5 (measured 3e-6)."""
    rng = np.random.default_rng(2)
    for shape in ((48, 64), (48, 64, 2), (48, 64, 3), (48, 64, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        ref = np.asarray(Image.fromarray(img).resize(size))
        got = dataset._resize_uint8(img, size)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(dataset._resize_uint8(img, (64, 48)), img)
    m = rng.random((48, 64)).astype(np.float32)
    ref = np.asarray(Image.fromarray(m, mode="F").resize(size, Image.BILINEAR))
    np.testing.assert_allclose(dataset._resize_map(m[None], size), ref, rtol=0, atol=1e-5)


def _model_arrays(rng, cap=300, n_alive=220, sh=2):
    k = (sh + 1) ** 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    params = dict(xyz=f(cap, 3), features_dc=f(cap, 1, 3), features_rest=f(cap, k - 1, 3),
                  scaling=f(cap, 3), rotation=f(cap, 4), opacity=f(cap, 1),
                  label=f(cap, 1), orient_conf=f(cap, 1), viewspace=np.zeros((cap, 3), np.float32))
    alive = np.zeros(cap, bool)
    alive[rng.choice(cap, n_alive, replace=False)] = True
    aux = dict(alive=alive, max_radii2d=f(cap), xyz_grad_accum=f(cap), denom=f(cap))
    return params, aux


def _jax_model(params, aux, sh):
    return j_gm.GaussianModelState(
        j_gm.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        j_gm.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()}),
        jnp.asarray(sh, jnp.int32), sh, 1.5)


def _fields_equal(a, b):
    assert a.dtype.names == b.dtype.names
    for name in a.dtype.names:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_ply_files_cross_read(tmp_path):
    """A model saved by either package: both files (raw_ with label_0, plain
    without) hold the same fields, and either package's load_ply gives the
    same padded state (dead rows: opacity -10, rotation w = 1; capacity 0
    rounds the row count up to 256)."""
    params, aux = _model_arrays(np.random.default_rng(3))
    tstate = gm.state_from_numpy(params, aux, 2, 2, 1.5, "cpu")
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    gm.save_ply(tstate, str(tmp_path / "t" / "point_cloud.ply"))
    j_gm.save_ply(_jax_model(params, aux, 2), str(tmp_path / "j" / "point_cloud.ply"))
    for name in ("raw_point_cloud.ply", "point_cloud.ply"):
        t_v = j_ply.read_ply(str(tmp_path / "t" / name))["vertex"]
        j_v = j_ply.read_ply(str(tmp_path / "j" / name))["vertex"]
        _fields_equal(t_v, j_v)
        assert ("label_0" in t_v.dtype.names) == name.startswith("raw_")
        assert len(t_v) == aux["alive"].sum()
    for src in ("t", "j"):
        path = str(tmp_path / src / "raw_point_cloud.ply")
        for cap in (0, 512):
            got = gm.load_ply(path, cap, 2, device="cpu")
            ref = j_gm.load_ply(path, cap, 2)
            assert got.capacity == ref.params.xyz.shape[0] == (256 if cap == 0 else 512)
            for name in gm.GaussianParams.names():
                np.testing.assert_array_equal(getattr(got.params, name).numpy(),
                                              np.asarray(getattr(ref.params, name)), err_msg=name)
            np.testing.assert_array_equal(got.aux.alive.numpy(), np.asarray(ref.aux.alive))
            assert got.active_sh_degree == int(ref.active_sh_degree) == 2


def test_colmap_files_round_trip(tmp_path):
    """Text files written by the port read back equal in both packages; the
    port's binary writers give files both packages' binary readers read."""
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 64, 48, np.array([50.5, 51.25, 32.0, 24.0])),
            2: colmap.ColmapCamera(2, "SIMPLE_PINHOLE", 64, 48, np.array([49.0, 32.0, 24.0]))}
    imgs = {3: colmap.ColmapImage(3, np.array([0.9, 0.1, -0.2, 0.3]), np.array([1.0, -2.0, 3.5]), 1,
                                  "a.png"),
            7: colmap.ColmapImage(7, np.array([1.0, 0, 0, 0]), np.array([0.0, 0, 1]), 2, "b.png")}
    rng = np.random.default_rng(4)
    xyz, rgb, err = rng.normal(size=(6, 3)), rng.integers(0, 256, (6, 3)).astype(np.uint8), rng.random(6)
    for kind in ("text", "binary"):
        d = tmp_path / kind
        d.mkdir()
        if kind == "text":
            colmap.write_cameras_text(str(d / "cameras.txt"), cams)
            colmap.write_images_text(str(d / "images.txt"), imgs)
        else:
            colmap.write_cameras_binary(str(d / "cameras.bin"), cams)
            colmap.write_images_binary(str(d / "images.bin"), imgs)
            colmap.write_points3d_binary(str(d / "points3D.bin"), xyz, rgb, err)
        for mod in (colmap, j_colmap):
            c, i, p = mod.read_model(str(d))
            assert {k: (v.model, v.width, v.height) for k, v in c.items()} == \
                {k: (v.model, v.width, v.height) for k, v in cams.items()}
            for k, v in cams.items():
                np.testing.assert_array_equal(c[k].params, v.params)
            for k, v in imgs.items():
                np.testing.assert_array_equal(i[k].qvec, v.qvec)
                np.testing.assert_array_equal(i[k].tvec, v.tvec)
                assert (i[k].camera_id, i[k].name) == (v.camera_id, v.name)
            if kind == "binary":
                for got, want in zip(p, (xyz, rgb, err)):
                    np.testing.assert_array_equal(got, want)
    R = colmap.qvec_to_rotmat(imgs[3].qvec / np.linalg.norm(imgs[3].qvec))
    np.testing.assert_allclose(colmap.qvec_to_rotmat(colmap.rotmat_to_qvec(R)), R, atol=1e-12)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("colmap_scene"))
    write_colmap_scene(bench_scene(300, 64, 48, 4, seed=5), root)
    return root


@pytest.mark.parametrize("split", [False, True], ids=["all", "eval"])
def test_load_scene_matches_jax(scene_dir, split):
    """The port's load_scene on a 4-view 64x48 COLMAP scene equals the JAX
    package's: cameras, splits, extent, point cloud and every GT array (the
    same PNG decode and no resize at this size: exact)."""
    ours = dataset.load_scene(ModelConfig(source_path=scene_dir, eval=split))
    ref = j_dataset.load_scene(JModelConfig(source_path=scene_dir, eval=split))
    assert ours.cameras_extent == ref.cameras_extent
    np.testing.assert_array_equal(ours.points, ref.points)
    np.testing.assert_array_equal(ours.colors, ref.colors)
    np.testing.assert_array_equal(ours.translate, ref.translate)
    for a_list, b_list in ((ours.train_cameras, ref.train_cameras),
                           (ours.test_cameras, ref.test_cameras)):
        assert [c.image_name for c in a_list] == [c.image_name for c in b_list]
        for a, b in zip(a_list, b_list):
            assert (a.width, a.height, a.fovx, a.fovy) == (b.width, b.height, b.fovx, b.fovy)
            np.testing.assert_array_equal(a.colmap_transform, b.colmap_transform)
            for name in ("image", "mask_hair", "mask_body", "orient_angle", "orient_conf"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert len(ours.test_cameras) == (2 if split else 0)
    # the written scene loads back as the in-memory one, quantized to 8 bits
    mem = bench_scene(300, 64, 48, 4, seed=5).train_cameras
    if not split:
        for a, b in zip(ours.train_cameras, mem):
            np.testing.assert_allclose(a.colmap_transform, b.colmap_transform, atol=1e-5)
            np.testing.assert_allclose(a.image, b.image, atol=0.5 / 255 + 1e-6)
            np.testing.assert_allclose(a.orient_conf, b.orient_conf, rtol=1e-3)


def _train_state_arrays(rng, n_cams=3):
    params, aux = _model_arrays(rng)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    like = lambda d: {k: f(*v.shape) for k, v in d.items()}
    cam = dict(rotation=f(n_cams, 3), translation=f(n_cams, 3), fov=f(n_cams, 2))
    return dict(params=params, aux=aux, opt_mu=like(params), opt_nu=like(params),
                opt_count=np.int32(17), cam_res=cam, cam_mu=like(cam), cam_nu=like(cam),
                cam_count=np.array([3, 0, 5], np.int32), step=17)


def _assert_states_equal(t, j):
    pairs = [(t.model.params, j.model.params), (t.model.aux, j.model.aux),
             (t.opt.mu, j.opt.mu), (t.opt.nu, j.opt.nu), (t.cam_res, j.cam_res),
             (t.cam_opt.mu, j.cam_opt.mu), (t.cam_opt.nu, j.cam_opt.nu)]
    for trec, jrec in pairs:
        for name in trec.names():
            np.testing.assert_array_equal(getattr(trec, name).numpy(),
                                          np.asarray(getattr(jrec, name)), err_msg=name)
    np.testing.assert_array_equal(t.opt.count.numpy(), np.asarray(j.opt.count))
    np.testing.assert_array_equal(t.cam_opt.count.numpy(), np.asarray(j.cam_opt.count))
    assert t.step == int(j.step)
    assert t.model.active_sh_degree == int(j.model.active_sh_degree)
    assert t.model.spatial_lr_scale == float(j.model.spatial_lr_scale)


def test_checkpoints_cross_load(tmp_path):
    """A checkpoint saved by each package loads in the other with equal
    arrays (the npz key names are shared)."""
    a = _train_state_arrays(np.random.default_rng(6))
    tstate = stage1.train_state_from_numpy(
        a["params"], a["aux"], a["opt_mu"], a["opt_nu"], a["opt_count"], a["cam_res"],
        a["cam_mu"], a["cam_nu"], a["cam_count"], a["step"], active_sh_degree=2,
        max_sh_degree=2, spatial_lr_scale=1.5, device="cpu")
    j = lambda d, cls: cls(**{k: jnp.asarray(v) for k, v in d.items()})
    jstate = j_stage1.TrainState(
        _jax_model(a["params"], a["aux"], 2),
        j_optim.AdamState(j(a["opt_mu"], j_gm.GaussianParams),
                          j(a["opt_nu"], j_gm.GaussianParams), jnp.asarray(a["opt_count"])),
        j(a["cam_res"], JCameraResiduals),
        j_stage1.CamAdamState(j(a["cam_mu"], JCameraResiduals),
                              j(a["cam_nu"], JCameraResiduals), jnp.asarray(a["cam_count"])),
        jnp.asarray(a["step"], jnp.int32))
    stage1.save_checkpoint(tstate, str(tmp_path / "t" / "17.npz"))
    j_stage1.save_checkpoint(jstate, str(tmp_path / "j" / "17.npz"))
    assert sorted(np.load(tmp_path / "t" / "17.npz").files) == \
        sorted(np.load(tmp_path / "j" / "17.npz").files)
    _assert_states_equal(stage1.load_checkpoint(str(tmp_path / "j" / "17.npz"), "cpu"), jstate)
    _assert_states_equal(tstate, j_stage1.load_checkpoint(str(tmp_path / "t" / "17.npz")))


def test_camera_pickles_read_by_jax(tmp_path, scene_dir):
    """cameras/<i>.pkl and <i>_matrices.pkl hold numpy arrays only and the
    JAX package's load_camera_residuals reads them back equal; the
    matrices match the JAX camera_geom's (rtol 1e-5, float32 products)."""
    scene = dataset.load_scene(ModelConfig(source_path=scene_dir))
    cams = scene.train_cameras
    rng = np.random.default_rng(8)
    res = CameraResiduals(*(torch.from_numpy(rng.normal(scale=0.01, size=s).astype(np.float32))
                            for s in ((4, 3), (4, 3), (4, 2))))
    model = gm.state_from_numpy(*_model_arrays(rng), 2, 2, 1.0, "cpu")
    state = stage1.init_train_state(model, len(cams), use_barf=True)
    state.cam_res = res
    cb = CameraBatch.from_cameras(cams, "cpu")
    stage1.save_camera_pickles(state, cams, cb, str(tmp_path), 9, True, 64, 48)
    with open(tmp_path / "cameras" / "9.pkl", "rb") as f:
        rot, trans, fov = pickle.load(f)
    with open(tmp_path / "cameras" / "9_matrices.pkl", "rb") as f:
        mats = pickle.load(f)
    for d in (rot, trans, fov, mats):
        assert all(type(v) is np.ndarray for v in d.values())
    jres = j_render.load_camera_residuals(str(tmp_path), 9, cams)
    for name in CameraResiduals.names():
        np.testing.assert_array_equal(np.asarray(getattr(jres, name)),
                                      getattr(res, name).numpy())
    from gaussianhaircut_tpu.scene.cameras import CameraBatch as JCameraBatch, camera_geom
    jcb = JCameraBatch.from_cameras(cams)
    for i, c in enumerate(cams):
        want = camera_geom(jcb.colmap_transform[i], jcb.fovx[i], jcb.fovy[i], 64, 48,
                           jres, i, use_barf=True).projmatrix
        np.testing.assert_allclose(mats[c.image_name], np.asarray(want), rtol=1e-5, atol=1e-6)
    assert math.isfinite(float(np.abs(mats[cams[0].image_name]).sum()))
