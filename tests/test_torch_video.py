"""The port's video postprocessing (``postprocessing/video.py``, the Blender
script and ``cli/render_video.py``) against the JAX package's on a tiny
on-disk COLMAP scene (200 points, three 64x48 views, SH degree 1):

- ``interpolate_camera_path`` equals JAX's (the same scipy calls);
- the AVI that ``write_video`` writes decodes through ``cv2.VideoCapture``
  to frames equal to the PNGs, with the frame count, fps and size that cv2
  reads from the JAX package's mp4 of the same frames, and the port's own
  parser reads back the PNG files' bytes; ``concat_videos`` writes the JAX
  layout, its panels resized within one level of ``cv2.resize``;
- ``render_video`` frames are within one level of the JAX CLI's on the same
  PLY (the JAX side on its ``jnp`` rasterizer), its ``blender_inputs``
  agree within 1e-6;
- the Blender script compiles and imports neither torch nor JAX, and
  ``blender_render`` raises without a Blender binary."""
import ast
import os
import pickle
import py_compile
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.cli import render_video as j_render_video
from gaussianhaircut_tpu.postprocessing import video as j_video
from gaussianhaircut_torch.cli import render_video as t_render_video
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.postprocessing import blender_render_script, video
from gaussianhaircut_torch.scene.synthetic import bench_scene, write_colmap_scene
from gaussianhaircut_torch.utils.image import read_png, write_png

FRAMES = 6
CAMERA_TOL = 1e-6


def _random_rotations(rng, n):
    from scipy.spatial.transform import Rotation
    return Rotation.from_rotvec(rng.normal(size=(n, 3))).as_matrix()


def test_interpolate_camera_path_matches_jax():
    rng = np.random.default_rng(0)
    rots, trans = _random_rotations(rng, 5), rng.normal(size=(5, 3))
    keys, samples = np.arange(5), np.linspace(0, 4, 37)
    for a, b in zip(video.interpolate_camera_path(rots, trans, keys, samples),
                    j_video.interpolate_camera_path(rots, trans, keys, samples)):
        np.testing.assert_array_equal(a, b)


def _frames(tmp_path, n=5, h=36, w=52, seed=0):
    rng = np.random.default_rng(seed)
    d = tmp_path / "frames"
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]
    for i, img in enumerate(imgs):
        write_png(str(d / f"{i:06d}.png"), img)
    return str(d), imgs


def _decode(path):
    cap = cv2.VideoCapture(path)
    info = [cap.get(k) for k in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FPS,
                                 cv2.CAP_PROP_FRAME_WIDTH, cv2.CAP_PROP_FRAME_HEIGHT)]
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return info, frames


def test_write_video_decodes_through_cv2(tmp_path):
    frames_dir, imgs = _frames(tmp_path)
    ours, ref = str(tmp_path / "v.avi"), str(tmp_path / "v.mp4")
    video.write_video(frames_dir, ours, fps=24)
    j_video.write_video(frames_dir, ref, fps=24)
    info, frames = _decode(ours)
    ref_info, ref_frames = _decode(ref)
    assert info == ref_info and len(ref_frames) == len(imgs)
    assert len(frames) == len(imgs)
    for got, img in zip(frames, imgs):
        np.testing.assert_array_equal(got, img[..., ::-1])
    avi = video.read_avi(ours)
    assert (avi["width"], avi["height"], avi["fps"], avi["fourcc"]) == (52, 36, 24.0, b"MPNG")
    names = sorted(os.listdir(frames_dir))
    assert avi["frames"] == [open(os.path.join(frames_dir, n), "rb").read() for n in names]


def test_write_video_refuses_mixed_sizes(tmp_path):
    frames_dir, _ = _frames(tmp_path, n=2)
    write_png(os.path.join(frames_dir, "000009.png"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="are not 52x36"):
        video.write_video(frames_dir, str(tmp_path / "v.avi"))
    with pytest.raises(FileNotFoundError):
        video.write_video(str(tmp_path), str(tmp_path / "v.avi"))


def test_resize_linear_matches_cv2():
    rng = np.random.default_rng(1)
    for (h, w), (nh, nw) in (((37, 53), (24, 34)), ((20, 30), (41, 61)), ((64, 48), (64, 48))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        diff = np.abs(video.resize_linear(img, nw, nh).astype(int)
                      - cv2.resize(img, (nw, nh)).astype(int))
        assert diff.max() <= 1, diff.max()


def test_concat_videos_matches_jax_layout(tmp_path):
    a, imgs_a = _frames(tmp_path / "a", n=3, h=36, w=52, seed=1)
    b, imgs_b = _frames(tmp_path / "b", n=4, h=48, w=40, seed=2)
    ours, ref = str(tmp_path / "c.avi"), str(tmp_path / "c.mp4")
    video.concat_videos([a, b], ours, fps=10)
    j_video.concat_videos([a, b], ref, fps=10)
    info, frames = _decode(ours)
    assert info == _decode(ref)[0] and len(frames) == 3
    bgr = lambda img: np.ascontiguousarray(img[..., ::-1])
    for got, ia, ib in zip(frames, imgs_a, imgs_b):
        want = np.concatenate([cv2.resize(bgr(ia), (52, 36)), cv2.resize(bgr(ib), (30, 36))], 1)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_blender_script_stands_alone(tmp_path):
    src = blender_render_script.__file__
    py_compile.compile(src, cfile=str(tmp_path / "c.pyc"), doraise=True)
    tree = ast.parse(open(src).read())
    top = {a.name.split(".")[0] for n in tree.body if isinstance(n, ast.Import) for a in n.names}
    every = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    every |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert top == {"os", "pickle", "sys"} and not every & {"torch", "jax", "gaussianhaircut_tpu"}
    assert "bpy" in every
    with pytest.raises(FileNotFoundError):
        video.blender_render("definitely-not-blender", str(tmp_path), str(tmp_path))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A scene and a model directory with one saved PLY (iteration 1)."""
    root = tmp_path_factory.mktemp("video")
    scene = str(root / "scene")
    data = bench_scene(200, 64, 48, 3, seed=3)
    write_colmap_scene(data, scene)
    state = gm.create_from_pcd(data.points, data.colors, 256, 1, 1.0, "cpu")
    gm.save_ply(state, str(root / "model" / "point_cloud" / "iteration_1" / "point_cloud.ply"))
    strands = str(root / "strands.pkl")
    with open(strands, "wb") as f:
        pickle.dump(np.zeros((2, 4, 3), np.float32), f)
    return dict(root=root, scene=scene, model=str(root / "model"), strands=strands)


def test_render_video_matches_jax(model, monkeypatch):
    """Both CLIs on copies of one model directory: six frames within one
    level, the port's AVI holding them, both ``cameras.pkl`` within 1e-6."""
    root = model["root"]
    ours, ref = str(root / "ours"), str(root / "ref")
    for d in (ours, ref):
        shutil.copytree(model["model"], d)
    common = ["-s", model["scene"], "--sh_degree", "1", "--num_frames", str(FRAMES),
              "--fps", "12", "--strands_pkl", model["strands"]]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    j_render_video.main(common + ["-m", ref, "--raster_backend", "jnp"])
    t_render_video.main(common + ["-m", ours, "--device", "cpu"])
    names = sorted(os.listdir(os.path.join(ref, "video_frames")))
    assert names == sorted(os.listdir(os.path.join(ours, "video_frames")))
    assert len(names) == FRAMES
    for n in names:
        a, b = (read_png(os.path.join(d, "video_frames", n)).astype(int) for d in (ours, ref))
        assert a.shape == (48, 64, 3) and np.abs(a - b).max() <= 1, n
    assert a.max() > 0
    avi = video.read_avi(os.path.join(ours, "video.avi"))
    assert len(avi["frames"]) == FRAMES and avi["fps"] == 12.0
    for d in (ours, ref):
        paths = dict(line.strip().split("=", 1)
                     for line in open(os.path.join(d, "blender_inputs", "inputs.txt")))
        assert paths["strands"] == model["strands"]
        assert paths["head"] == os.path.join(d, "point_cloud", "iteration_1", "point_cloud.ply")
    got, want = (pickle.load(open(os.path.join(d, "blender_inputs", "cameras.pkl"), "rb"))
                 for d in (ours, ref))
    assert sorted(got) == sorted(want) and len(got) == FRAMES
    for k in want:
        assert sorted(got[k]) == sorted(want[k]) == ["Rt", "fx", "fy", "height", "width"]
        for key in want[k]:
            np.testing.assert_allclose(np.asarray(got[k][key]), np.asarray(want[k][key]),
                                       rtol=CAMERA_TOL, atol=CAMERA_TOL, err_msg=f"{k} {key}")


def test_render_video_frame_is_render_frame(model):
    """Each frame is one render of the path camera on the model's device:
    ``render_frame`` gives the image ``render_video`` saved."""
    from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
    from gaussianhaircut_torch.render.renderer import default_background
    from gaussianhaircut_torch.scene.dataset import load_scene
    from gaussianhaircut_torch.config import ModelConfig
    out = str(model["root"] / "again")
    shutil.copytree(model["model"], out)
    t_render_video.main(["-s", model["scene"], "-m", out, "--sh_degree", "1",
                         "--num_frames", "3", "--device", "cpu"])
    cams = load_scene(ModelConfig(source_path=model["scene"]), load_gt=False).train_cameras
    path = t_render_video.camera_path(cams, 3)
    state = gm.load_ply(os.path.join(out, "point_cloud", "iteration_1", "raw_point_cloud.ply"),
                        0, 1, device="cpu")
    img = t_render_video.render_frame(state, path[2], cams[0].fovx, cams[0].fovy, 64, 48,
                                      default_background(False, "cpu"), RasterConfig())
    want = (np.clip(img.numpy().transpose(1, 2, 0), 0, 1) * 255).round().astype(np.uint8)
    np.testing.assert_array_equal(read_png(os.path.join(out, "video_frames", "000002.png")), want)
    assert isinstance(img, torch.Tensor) and not img.requires_grad
