"""The port's orchestrator end to end on the CPU, and its files across
packages, on a toy scene (3 views of 64x64, 400 points, a 10x8 sphere as
the FLAME head):

- ``run_pipeline --device cpu`` goes from ``images/`` + ``masks/`` +
  ``sparse/0`` through filter, resize, orientation maps, colmap_to_h3ds,
  stage 1, the crop and head filter, the synthetic-GT export, stages 2 and
  3, export_curves and render_strands;
- the JAX package's ``render_strands`` renders the port's stage-3
  checkpoint over the port's filtered head (held against the port's
  renders: PNGs within 1 level, ``orient_confs`` within atol 1e-4), and its
  metrics CLI scores the port's renders (``test_torch_pipeline_files.py``
  has the JAX trainers on the port's scene files);
- ``convert`` shells out to COLMAP with the JAX CLI's commands.

Tiny strands (8 x 8, texture 16) and a UNet cut to channels (32, 64) in
both packages, as ``tests/test_torch_stage2.py`` cuts the JAX one."""
import functools
import os
import pickle
import shutil
import stat
import sys

import numpy as np
import pytest

from gaussianhaircut_tpu.cli import convert as j_convert
from gaussianhaircut_tpu.cli import metrics as j_metrics
from gaussianhaircut_tpu.cli import render_strands as j_render_strands
from gaussianhaircut_tpu.models import diffusion as jd
from gaussianhaircut_torch.cli import convert, run_pipeline
from gaussianhaircut_torch.models import prior_io
from gaussianhaircut_torch.preprocessing import frames
from gaussianhaircut_torch.scene.synthetic import toy_pipeline_scene
from gaussianhaircut_torch.train import stage2
from gaussianhaircut_torch.utils.image import read_png

ITERS = (3, 2, 2)
SMALL_UNET = dict(channels=(32, 64), depths=(1, 1))
TRAIN = "--tile 16 --gaussian_capacity 512 --test_iterations -1"
STRANDS = "--num_strands 8 --texture_size 16 --strand_length 8 --diffusion_input 4"


@pytest.fixture(scope="module")
def small_unet():
    mp = pytest.MonkeyPatch()
    for mod in (stage2, prior_io, jd):
        mp.setattr(mod, "DiffusionConfig", functools.partial(mod.DiffusionConfig, **SMALL_UNET))
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory, small_unet):
    data = str(tmp_path_factory.mktemp("pipeline") / "scene")
    toy_pipeline_scene(data)
    run_pipeline.main(["--data_path", data, "--device", "cpu", "--iters1", str(ITERS[0]),
                       "--iters2", str(ITERS[1]), "--iters3", str(ITERS[2]),
                       "--extra_train_args", TRAIN, "--extra_strand_args", STRANDS])
    return data


def test_run_pipeline_reaches_export(pipeline):
    """Every stage's files exist and load back: the resized images and
    masks, the orientation maps, cameras.npz, the stage-1 model, the crop
    and head filter, the synthetic GT, both strand checkpoints, the
    exported strands and the strand renders."""
    d = pipeline
    i1, i2, i3 = ITERS
    model = f"{d}/3d_gaussian_splatting/stage1"
    for f in ("images_2/000000.png", "images_4/000000.png", "masks_2/hair/000000.png",
              "masks_4/face/000000.png", "orientations_2/angles/000000.png",
              "orientations_2/vars/000000.npy", "orientations_2/vis/000000.png",
              "orientations_2/filtered/000000.png", "cameras.npz", "point_cloud.ply",
              "scale.pickle",
              f"{model}/point_cloud/iteration_{i1}/raw_point_cloud.ply",
              f"{model}/point_cloud_cropped/iteration_{i1}/raw_point_cloud.ply",
              f"{model}/point_cloud_filtered/iteration_{i1}/raw_point_cloud.ply",
              f"{model}/train_cropped/ours_{i1}/renders/000000.png",
              f"strands_reconstruction/stage2/checkpoints/{i2}.npz",
              f"curves_reconstruction/stage3/checkpoints/{i3}.npz",
              f"strands_reconstruction/stage2/train/ours_{i1}/renders/000000.png"):
        assert os.path.exists(os.path.join(d, f)), f
    assert read_png(f"{d}/images_2/000000.png").shape == (32, 32, 3)
    assert read_png(f"{d}/masks_4/hair/000000.png").shape == (16, 16)
    with np.load(f"{d}/cameras.npz") as z:
        assert sorted(z.files) == sorted(f"{k}_mat_{i}" for k in ("world", "scale")
                                         for i in range(3))
    with open(f"{d}/scale.pickle", "rb") as f:
        scale = pickle.load(f)
    assert scale["scale"] > 0 and len(scale["translation"]) == 3
    with open(f"{d}/curves_reconstruction/stage3/strands/{i3}_strands.pkl", "rb") as f:
        pts = pickle.load(f)
    assert pts.shape == (8, 8, 3) and np.isfinite(pts).all()


def test_render_strands_matches_jax(pipeline, tmp_path):
    """The JAX render_strands of the port's stage-3 checkpoint and scene:
    every PNG within 1 level of the port's render, orient_confs within
    atol 1e-4; then the JAX metrics CLI scores the port's renders."""
    d = pipeline
    i1, i3 = ITERS[0], ITERS[2]
    jax_hair = str(tmp_path / "hair_jax")
    j_render_strands.main([
        "-s", d, "-m", f"{d}/3d_gaussian_splatting/stage1", "--model_hair_path", jax_hair,
        "--checkpoint_curves", f"{d}/curves_reconstruction/stage3/checkpoints/{i3}.npz",
        "--skip_test", "--raster_backend", "jnp", "--tile", "16"])
    ours = f"{d}/strands_reconstruction/stage2/train/ours_{i1}"
    ref = f"{jax_hair}/train/ours_{i1}"
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    for kind in sorted(os.listdir(ref)):
        assert sorted(os.listdir(f"{ours}/{kind}")) == sorted(os.listdir(f"{ref}/{kind}"))
        for name in sorted(os.listdir(f"{ref}/{kind}")):
            if name.endswith(".npy"):
                np.testing.assert_allclose(np.load(f"{ours}/{kind}/{name}"),
                                           np.load(f"{ref}/{kind}/{name}"), rtol=0, atol=1e-4)
            else:
                a = read_png(f"{ours}/{kind}/{name}").astype(int)
                b = read_png(f"{ref}/{kind}/{name}").astype(int)
                assert np.abs(a - b).max() <= 1, (kind, name)

    method = tmp_path / "eval" / "test" / "ours"
    shutil.copytree(f"{ours}/renders", method / "renders")
    os.makedirs(method / "gt")
    for name in os.listdir(method / "renders"):
        shutil.copy(f"{d}/images_2/{name}", method / "gt" / name)
    res = j_metrics.evaluate([str(tmp_path / "eval")])[str(tmp_path / "eval")]["ours"]
    assert np.isfinite(res["SSIM"]) and np.isfinite(res["PSNR"])


def test_frames_need_a_decoder(tmp_path):
    """Without ``input/`` the pipeline would decode ``raw.mp4``: the port
    has no video decoder and says so."""
    d = tmp_path / "scene"
    d.mkdir()
    (d / "raw.mp4").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="video decoder"):
        run_pipeline.main(["--data_path", str(d), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="video decoder"):
        frames.extract_frames(str(d / "raw.mp4"), str(d / "input"))


_STUB = """#!{python}
import os, sys
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
args = dict(zip(sys.argv[2::2], sys.argv[3::2]))
if sys.argv[1] == "image_undistorter":
    os.makedirs(os.path.join(args["--output_path"], "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join(args["--output_path"], "sparse", name), "w").close()
"""


@pytest.mark.parametrize("flags", [[], ["--no_gpu", "--camera", "PINHOLE"], ["--skip_matching"]])
def test_convert_issues_the_jax_commands(tmp_path, flags):
    """A stub ``colmap`` that records its arguments: the port's convert
    issues the JAX CLI's commands in the same order, and moves the
    undistorter's model into sparse/0 as it does."""
    logs = {}
    for pkg, main in (("jax", j_convert.main), ("port", convert.main)):
        src = tmp_path / pkg / "scene"
        src.mkdir(parents=True)
        stub = tmp_path / pkg / "colmap"
        stub.write_text(_STUB.format(python=sys.executable, log=str(tmp_path / pkg / "log")))
        stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
        main(["-s", str(src), "--colmap_executable", str(stub)] + flags)
        assert sorted(os.listdir(src / "sparse" / "0")) == [
            "cameras.bin", "images.bin", "points3D.bin"]
        logs[pkg] = (tmp_path / pkg / "log").read_text().replace(str(tmp_path / pkg), "ROOT")
    assert logs["port"] == logs["jax"]
    assert len(logs["port"].splitlines()) == (2 if "--skip_matching" in flags else 5)
