"""The port stands alone: no module of ``gaussianhaircut_torch`` (nor
``chip_smoke.py``) imports JAX, flax or ``gaussianhaircut_tpu``, nor a
package the GPU machine lacks (PIL, TensorBoard, plyfile, imageio, OpenCV,
optax, torchvision, lpips); a CPU step, the 1x1 mesh step of
``parallel/``, the stage-1 CLIs, ``render_video``, ``train_gaussians --gui``
with a viewer, ``calc_masks``, the strand CLIs, the orchestrator on a toy
scene, the metrics CLI, the scalp stage, the face glue, the synthetic-scene
layout, both quality harnesses, the three converters (their selftests and
their conversions of fabricated upstream files), the stage-3 lr probe and
the pipeline record run with all of those unimportable; the entry points
never pick the CPU on their own; and the kernel wrappers keep CUDA tensors
away from the plain versions."""
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gaussianhaircut_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussianhaircut_tpu")
# not installed on the GPU machine
ABSENT_ON_CARD = ("PIL", "tensorboard", "torch.utils.tensorboard", "plyfile", "imageio", "cv2",
                  "optax", "torchvision", "lpips")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    for name in _imported_modules(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_the_card_lacks(path):
    for name in _imported_modules(path):
        parts = name.split(".")
        prefixes = {".".join(parts[:i]) for i in range(1, len(parts) + 1)}
        assert not prefixes & set(ABSENT_ON_CARD), f"{path} imports {name}"


_SCRIPT = textwrap.dedent("""
    import importlib, math, os, pkgutil, sys, tempfile, types
    for name in ("jax", "jaxlib", "flax", "PIL", "tensorboard",
                 "torch.utils.tensorboard", "plyfile", "imageio", "cv2", "optax",
                 "torchvision", "lpips"):
        sys.modules[name] = None          # any import of them now fails
    import numpy as np
    import torch
    import gaussianhaircut_torch
    for mod in pkgutil.walk_packages(gaussianhaircut_torch.__path__,
                                     "gaussianhaircut_torch."):
        importlib.import_module(mod.name)
    from gaussianhaircut_torch import kernels
    from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussianhaircut_torch.scene.cameras import CameraStatic
    from gaussianhaircut_torch.train import stage1

    rng = np.random.default_rng(0)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.5
    cam = CameraStatic(uid=0, colmap_id=0, image_name="0", width=32, height=32,
                       colmap_transform=w2c, fovx=math.radians(50), fovy=math.radians(50))
    cam.image = rng.uniform(size=(3, 32, 32)).astype(np.float32)
    cam.mask_hair = np.ones((1, 32, 32), np.float32)
    cam.mask_body = np.ones((1, 32, 32), np.float32)
    cam.orient_angle = rng.uniform(size=(1, 32, 32)).astype(np.float32)
    cam.orient_conf = np.ones((1, 32, 32), np.float32)
    scene = types.SimpleNamespace(
        train_cameras=[cam], points=rng.normal(scale=0.3, size=(50, 3)).astype(np.float32),
        colors=rng.uniform(size=(50, 3)).astype(np.float32), cameras_extent=1.0)
    losses = []
    stage1.train(ModelConfig(sh_degree=1), OptimizationConfig(iterations=1),
                 PipelineConfig(gaussian_capacity=64), scene, device="cpu",
                 progress_callback=lambda it, st, m: losses.append(float(m["total"])))
    assert len(losses) == 1 and math.isfinite(losses[0]), losses
    # the mesh step of parallel/ (a 1x1 mesh needs no launcher)
    state = stage1.train(ModelConfig(sh_degree=1), OptimizationConfig(iterations=1),
                         PipelineConfig(gaussian_capacity=64), scene, device="cpu",
                         mesh_spec="1x1")
    assert state.step == 1

    # the stage-1 CLIs on a one-view scene written to disk
    from gaussianhaircut_torch.cli import render_gaussians, train_gaussians
    from gaussianhaircut_torch.scene.synthetic import bench_scene, write_colmap_scene
    root = tempfile.mkdtemp()
    src, model = os.path.join(root, "scene"), os.path.join(root, "model")
    write_colmap_scene(bench_scene(50, 32, 32, 1), src)
    state = train_gaussians.main(
        ["-s", src, "-m", model, "--device", "cpu", "--sh_degree", "1",
         "--gaussian_capacity", "64", "--iterations", "1", "--test_iterations", "1",
         "--save_iterations", "1", "--checkpoint_iterations", "1"])
    assert state.step == 1
    render_gaussians.main(["-s", src, "-m", model, "--device", "cpu", "--sh_degree", "1"])
    assert len(os.listdir(os.path.join(model, "train", "ours_1", "renders"))) == 1

    # the video, the live viewer and the mask fallback
    import socket, struct, threading
    from gaussianhaircut_torch.cli import calc_masks, render_video
    from gaussianhaircut_torch.postprocessing.video import read_avi
    from gaussianhaircut_torch.render import network_gui
    src2 = os.path.join(root, "scene2")                # the path needs two cameras
    write_colmap_scene(bench_scene(50, 32, 32, 2), src2)
    render_video.main(["-s", src2, "-m", model, "--device", "cpu", "--sh_degree", "1",
                       "--num_frames", "2"])
    assert len(read_avi(os.path.join(model, "video.avi"))["frames"]) == 2
    init = network_gui.init
    def init_and_ask(host, port):
        init(host, port)
        sock = socket.create_connection(network_gui.listener.getsockname(), timeout=60)
        sock.settimeout(60)
        body = struct.pack("IIbbbbf", 0, 0, 1, 0, 0, 0, 1.0) + bytes(128) + struct.pack("I", 0)
        def ask():
            sock.sendall(struct.pack("I", len(body)) + body)
            n = struct.unpack("<I", sock.recv(4))[0]
            replies.append(sock.recv(n))
            sock.close()
        threading.Thread(target=ask, daemon=True).start()
    replies = []
    network_gui.init = init_and_ask
    gui_model = os.path.join(root, "gui")
    train_gaussians.main(["-s", src, "-m", gui_model, "--device", "cpu", "--sh_degree", "1",
                          "--gaussian_capacity", "64", "--iterations", "1", "--gui",
                          "--port", "0", "--test_iterations", "-1", "--save_iterations", "1",
                          "--checkpoint_iterations", "-1"])
    network_gui.listener.close()
    network_gui.listener = network_gui.conn = None
    assert replies == [os.path.abspath(src).encode()], replies
    from gaussianhaircut_torch.utils.image import write_png
    write_png(os.path.join(root, "masks_scene", "input", "0.png"),
              rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    calc_masks.main(["--scene_path", os.path.join(root, "masks_scene"), "--device", "cpu"])
    assert all(os.path.exists(os.path.join(root, "masks_scene", "masks", m, "0.png"))
               for m in ("hair", "face", "body"))

    # the strand CLIs on that model: stage 2, stage 3 with a fresh SDS prior, export
    from gaussianhaircut_torch.cli import export_curves, train_latent_strands, train_strands
    strand = ["-s", src, "-m", model, "--device", "cpu", "--sh_degree", "1",
              "--num_strands", "8", "--strand_length", "4", "--texture_size", "8",
              "--diffusion_input", "4", "--iterations", "1", "--checkpoint_iterations", "1"]
    hair = os.path.join(root, "hair")
    curves = os.path.join(root, "curves_reconstruction", "c")
    train_latent_strands.main(strand + ["--model_path_hair", hair])
    train_strands.main(strand + ["--model_path_hair", hair, "--model_path_curves", curves,
                                 "--start_checkpoint_hair",
                                 os.path.join(hair, "checkpoints", "1.npz"), "--use_sds"])
    pts = export_curves.main(["--data_dir", root, "--model_name", "c", "--iter", "1",
                              "--device", "cpu"])
    assert pts.shape == (8, 4, 3) and np.isfinite(pts).all(), pts.shape

    # the orchestrator on a toy scene (UNet cut to channels 32, 64), then
    # the metrics CLI on its strand renders
    import functools, shutil
    from gaussianhaircut_torch.cli import metrics, run_pipeline
    from gaussianhaircut_torch.models import prior_io
    from gaussianhaircut_torch.scene.synthetic import toy_pipeline_scene
    from gaussianhaircut_torch.train import stage2
    for mod in (stage2, prior_io):
        mod.DiffusionConfig = functools.partial(mod.DiffusionConfig, channels=(32, 64),
                                                depths=(1, 1))
    data = os.path.join(root, "pipeline")
    toy_pipeline_scene(data)
    run_pipeline.main(["--data_path", data, "--device", "cpu", "--iters1", "2", "--iters2", "1",
                       "--iters3", "1", "--extra_train_args",
                       "--tile 16 --gaussian_capacity 512 --test_iterations -1",
                       "--extra_strand_args",
                       "--num_strands 8 --texture_size 16 --strand_length 8 --diffusion_input 4"])
    ev = os.path.join(root, "eval", "test", "ours")
    shutil.copytree(os.path.join(data, "strands_reconstruction", "stage2", "train", "ours_2",
                                 "renders"), os.path.join(ev, "renders"))
    shutil.copytree(os.path.join(data, "images_2"), os.path.join(ev, "gt"))
    res = metrics.main(["-m", os.path.join(root, "eval"), "--device", "cpu"])
    assert math.isfinite(res[os.path.join(root, "eval")]["ours"]["PSNR"]), res

    # the scalp stage on the toy scene's head, masks and stage-1 cameras
    import pickle
    from gaussianhaircut_torch.preprocessing import scalp
    flame = os.path.join(data, "flame_fitting", "stage1")
    with open(os.path.join(data, "3d_gaussian_splatting", "stage1", "cameras",
                           "2_matrices.pkl"), "rb") as f:
        scalp.extract_scalp(flame, data, pickle.load(f), device="cpu")
    assert sorted(os.listdir(os.path.join(flame, "scalp_data"))) == [
        "cut_scalp_verts.pickle", "dif_mask.png", "scalp.obj"]

    # the new entry points as `python -m` would run them: the face glue,
    # the synthetic-scene layout and both quality harnesses at a tiny size
    import runpy
    from gaussianhaircut_torch.train import prior
    prior.DiffusionConfig = stage2.DiffusionConfig
    def run_module(name, *argv):
        sys.argv = [name, *argv]
        runpy.run_module(name, run_name="__main__", alter_sys=True)
    run_module("gaussianhaircut_torch.cli.calc_face_alignment", "--data_path", data)
    assert os.path.exists(os.path.join(data, "face_alignment", "lmks_2d.pkl"))
    os.makedirs(os.path.join(root, "pixie", "0"))
    with open(os.path.join(root, "pixie", "0", "0_param.pkl"), "wb") as f:
        pickle.dump({"shape": np.zeros(3)}, f)
    run_module("gaussianhaircut_torch.cli.merge_smplx_predictions", "--data_path", root)
    assert os.path.exists(os.path.join(root, "initialization_pixie"))
    run_module("gaussianhaircut_torch.preprocessing.synthetic_scene", "--src", data,
               "--dst", os.path.join(root, "synthetic"))
    assert os.path.isdir(os.path.join(root, "synthetic", "images_2"))
    run_module("gaussianhaircut_torch.tools.quality_run", "--iters", "2", "--teacher_p", "100",
               "--res", "32", "--views", "1", "--test_views", "1", "--device", "cpu",
               "--out", os.path.join(root, "q1.json"))
    run_module("gaussianhaircut_torch.tools.quality_strands", "--iters2", "1", "--iters3", "1",
               "--res", "32", "--views", "1", "--test_views", "1", "--teacher_strands", "12",
               "--num_strands", "8", "--strand_length", "4", "--pool_size", "200",
               "--texture_size", "32", "--use_sds_stage3", "--prior_steps", "1",
               "--device", "cpu", "--out", os.path.join(root, "q2.json"))
    assert all(os.path.exists(os.path.join(root, q)) for q in ("q1.json", "q2.json"))
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches

    # with no device and no CUDA, train() raises instead of using the CPU
    torch.cuda.is_available = lambda: False
    try:
        stage1.train(ModelConfig(sh_degree=1), OptimizationConfig(iterations=1),
                     PipelineConfig(gaussian_capacity=64), scene)
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), e
    else:
        raise AssertionError("train() without a device ran without CUDA")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("gaussianhaircut_tpu", "jax", "flax", "PIL")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("ISOLATED")
""")


# the tools as `python -m` runs them
_TOOLS_PREAMBLE = textwrap.dedent("""
    import json, os, runpy, sys, tempfile
    for name in ("jax", "jaxlib", "flax", "PIL", "tensorboard",
                 "torch.utils.tensorboard", "plyfile", "imageio", "cv2", "optax",
                 "torchvision", "lpips"):
        sys.modules[name] = None          # any import of them now fails
    import numpy as np
    from gaussianhaircut_torch import kernels

    def run_tool(name, *argv):
        sys.argv = [name, *argv]
        try:
            runpy.run_module("gaussianhaircut_torch.tools." + name, run_name="__main__",
                             alter_sys=True)
        except SystemExit as e:
            assert e.code in (0, None), (name, e.code)
""")
_TOOLS_EPILOGUE = textwrap.dedent("""
    assert all(n == 0 for n in kernels.launches.values()), kernels.launches
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("gaussianhaircut_tpu", "jax", "flax", "PIL", "cv2",
                                           "torchvision", "lpips", "optax")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("ISOLATED")
""")
_SELFTESTS_SCRIPT = _TOOLS_PREAMBLE + textwrap.dedent("""
    for tool in ("convert_lpips", "convert_neuralhaircut_ckpt", "convert_hyperiqa"):
        run_tool(tool, "--selftest", "--device", "cpu")
""") + _TOOLS_EPILOGUE
_TOOLS_SCRIPT = _TOOLS_PREAMBLE + textwrap.dedent("""
    from gaussianhaircut_torch.models.textured_strands import TexturedStrandsConfig
    from gaussianhaircut_torch.tools import pipeline_e2e_run
    from gaussianhaircut_torch.train import stage2
    from gaussianhaircut_torch.utils.image import write_png

    root, twins = tempfile.mkdtemp(), os.environ["GHT_TWINS"]
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(os.path.join(root, "frames", f"{i}.png"),
                  rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    hair = os.path.join(root, "hair.npz")
    stage2.save_checkpoint(stage2.init_hair_state(TexturedStrandsConfig(
        num_strands=8, texture_size=8, strand_length=4, sh_degree=1, pool_size=200),
        device="cpu"), hair)

    # the three converters on the fabricated upstream files
    run_tool("convert_lpips", "--vgg16", os.path.join(twins, "vgg16.pth"),
             "--lpips_heads", os.path.join(twins, "vgg.pth"), "--out",
             os.path.join(root, "lpips.npz"), "--device", "cpu")
    run_tool("convert_neuralhaircut_ckpt", "--neuralhaircut_dir",
             os.path.join(twins, "NeuralHaircut"), "--strand_ckpt",
             os.path.join(twins, "strand_ckpt.pth"), "--out", os.path.join(root, "prior.npz"),
             "--steps", "2", "--batch", "8", "--device", "cpu")
    run_tool("convert_hyperiqa", "--hyperiqa_dir", os.path.join(twins, "hyperIQA"),
             "--frames_dir", os.path.join(root, "frames"), "--out",
             os.path.join(root, "iqa.npz"), "--steps", "2", "--batch", "2", "--device", "cpu")
    # the lr probe and the pipeline record
    run_tool("s3_lr_probe", "--ckpt", hair, "--iters", "1", "--lrs", "0.2", "--res", "32",
             "--views", "1", "--test_views", "1", "--num_strands", "8",
             "--teacher_strands", "8", "--strand_length", "4", "--pool_size", "200",
             "--texture_size", "8", "--device", "cpu", "--out", os.path.join(root, "probe.json"))
    pipeline_e2e_run.build_scene(os.path.join(root, "e2e"), 1, 32, 20, 8, device="cpu")
    assert sorted(os.listdir(os.path.join(root, "e2e", "sparse", "0"))) == [
        "cameras.txt", "images.txt", "points3D.txt"]
    # the run itself on a missing scene: the orchestrator stops after its
    # first stage (no COLMAP model), which the record times
    run_tool("pipeline_e2e_run", "--skip_build", "--scene",
             os.path.join(root, "e2e_missing", "scene"), "--out",
             os.path.join(root, "e2e.json"), "--device", "cpu")
    for out in ("lpips.npz", "prior.npz", "iqa.npz", "probe.json", "e2e.json"):
        assert os.path.exists(os.path.join(root, out)), out
    with open(os.path.join(root, "e2e.json")) as f:
        rec = json.load(f)
    assert rec["returncode"] != 0 and list(rec["stage_seconds"]) == ["frames"], rec
""") + _TOOLS_EPILOGUE

def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ISOLATED" in res.stdout


def test_converter_selftests_run_without_jax():
    """The three converters' ``--selftest`` as ``python -m`` runs them, with
    JAX, PIL, cv2, optax, torchvision and lpips unimportable."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _SELFTESTS_SCRIPT], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ISOLATED" in res.stdout


def test_tools_run_without_jax(tmp_path):
    """The converters on fabricated upstream files, the lr probe and the
    pipeline record, as ``python -m`` runs them, with JAX, PIL, cv2, optax,
    torchvision and lpips unimportable."""
    from tests.upstream_twins import (
        write_hyperiqa_tree, write_lpips_files, write_neuralhaircut_tree,
    )
    from gaussianhaircut_torch.ops.lpips import synthesize_weights
    write_lpips_files(str(tmp_path), synthesize_weights(0))
    write_neuralhaircut_tree(str(tmp_path))
    write_hyperiqa_tree(str(tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO, GHT_TWINS=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", _TOOLS_SCRIPT], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ISOLATED" in res.stdout


def test_cuda_backend_refuses_cpu_tensors():
    """The route follows the tensors' device and nothing else: the kernel
    route refuses CPU tensors, and rasterize() on CPU tensors runs the plain
    versions without counting a launch."""
    from gaussianhaircut_torch import kernels
    from gaussianhaircut_torch.ops.rasterize import cuda_core
    from gaussianhaircut_torch.ops.rasterize.api import rasterize
    from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
    cfg = RasterConfig()
    with pytest.raises(ValueError, match="payload is .* on cpu; expected .* on a CUDA device"):
        cuda_core._check_layout(torch.zeros(1, 24, cfg.chunk),
                                torch.zeros(1, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32), cfg)
    assert not hasattr(cfg, "backend")
    p = 4
    before = dict(kernels.launches)
    out = rasterize(torch.zeros(p, 3), torch.ones(p, 3), torch.zeros(p, 10),
                    torch.ones(p, 1), torch.ones(p), torch.ones(p, dtype=torch.bool),
                    torch.zeros(10), 32, 32, cfg)
    assert out["render"].shape == (10, 32, 32)
    assert kernels.launches == before


def test_kernel_checks_reject_cpu_tensors():
    """The kernel-side checks refuse anything but contiguous float32 CUDA
    tensors of the expected shape."""
    from gaussianhaircut_torch import kernels
    with pytest.raises(ValueError, match="payload is .* on cpu; expected .* on a CUDA device"):
        kernels.check_arg("payload", torch.zeros(1, 24, 256), torch.float32)


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """No device given means CUDA: without it resolve_device, the CLIs
    (``convert`` aside: it only runs COLMAP; the face glue and the
    synthetic-scene layout use no device), the orientation maps, the winding
    number, the resize, the scalp stage, the prior, the quality harnesses,
    the converters, the lr probe and the pipeline record raise (before
    reading any file) instead of running on the CPU."""
    from gaussianhaircut_torch.cli import render_gaussians, train_gaussians
    from gaussianhaircut_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    for main in (train_gaussians.main, render_gaussians.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["-s", str(tmp_path / "missing"), "-m", str(tmp_path / "model")])
    from gaussianhaircut_torch.cli import (
        export_curves, export_strands, metrics, render_strands, run_pipeline,
        train_latent_strands, train_strands)
    from gaussianhaircut_torch.preprocessing import orientation_maps, scene_tools
    from gaussianhaircut_torch.scene.synthetic import sphere_mesh
    strand = ["-s", str(tmp_path / "missing"), "-m", str(tmp_path / "model"),
              "--model_path_hair", str(tmp_path / "hair")]
    missing = str(tmp_path / "missing")
    from gaussianhaircut_torch.models.textured_strands import TexturedStrandsConfig
    from gaussianhaircut_torch.preprocessing import scalp
    from gaussianhaircut_torch.tools import (
        convert_hyperiqa, convert_lpips, convert_neuralhaircut_ckpt, pipeline_e2e_run,
        quality_run, quality_strands, s3_lr_probe,
    )
    from gaussianhaircut_torch.train import prior
    strands = np.zeros((4, 5, 3))
    for call in (lambda: orientation_maps.calc_orientation_map(np.zeros((8, 8, 3))),
                 lambda: scalp.rasterize_pix_to_face(np.zeros((3, 2)), np.ones(3),
                                                     np.array([[0, 1, 2]]), 4, 4),
                 lambda: scalp.extract_scalp(missing, missing, {}),
                 lambda: prior.distill_strand_prior(strands, np.zeros((4, 2)),
                                                    np.tile(np.eye(3), (4, 1, 1)),
                                                    TexturedStrandsConfig(), steps=1),
                 lambda: prior.pretrain_strand_decoder(strands, np.tile(np.eye(3), (4, 1, 1)),
                                                       TexturedStrandsConfig(), steps=1),
                 lambda: quality_run.main(["--iters", "1"]),
                 lambda: quality_strands.main(["--iters2", "1"]),
                 lambda: convert_lpips.main(["--selftest"]),
                 lambda: convert_lpips.main(["--vgg16", missing, "--lpips_heads", missing]),
                 lambda: convert_neuralhaircut_ckpt.main(["--selftest"]),
                 lambda: convert_neuralhaircut_ckpt.main([
                     "--neuralhaircut_dir", missing, "--strand_ckpt", missing, "--out", missing]),
                 lambda: convert_hyperiqa.main(["--selftest"]),
                 lambda: convert_hyperiqa.main(["--hyperiqa_dir", missing, "--frames_dir",
                                                missing, "--out", missing]),
                 lambda: s3_lr_probe.main(["--ckpt", missing]),
                 lambda: pipeline_e2e_run.main(["--scene", missing]),
                 lambda: pipeline_e2e_run.build_scene(missing, 1, 32, 20, 8),
                 lambda: scene_tools.mesh_sdf_sign(np.zeros((2, 3)), sphere_mesh(n_lat=4,
                                                                                  n_lon=4)),
                 lambda: scene_tools.resize_images(missing),
                 lambda: render_strands.main(strand[:-2] + [
                     "--model_hair_path", missing, "--checkpoint_curves", missing]),
                 lambda: export_strands.main(["--data_dir", missing, "--model_name", "m"]),
                 lambda: metrics.main(["-m", missing]),
                 lambda: run_pipeline.main(["--data_path", missing]),
                 lambda: orientation_maps.main(sum(
                     ([f"--{k}", missing] for k in ("img_path", "mask_path", "orient_dir",
                                                    "conf_dir", "filtered_img_dir",
                                                    "vis_img_dir")), []))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    from gaussianhaircut_torch.cli import calc_masks, render_video
    for main, argv in ((render_video.main, ["-s", missing, "-m", str(tmp_path / "model")]),
                       (calc_masks.main, ["--scene_path", missing]),
                       (train_latent_strands.main, strand),
                       (train_strands.main, strand + [
                           "--model_path_curves", str(tmp_path / "curves"),
                           "--start_checkpoint_hair", str(tmp_path / "missing.npz")]),
                       (export_curves.main, ["--data_dir", str(tmp_path / "missing"),
                                             "--model_name", "m"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
