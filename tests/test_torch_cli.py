"""Parity of the port's stage-1 CLIs with the JAX package's on a tiny
on-disk COLMAP scene (150 points, two 64x48 views): ``train_gaussians`` for
three iterations with evaluation, PLY, checkpoint and camera pickles at 3,
``evaluate`` on the same state, and ``render_gaussians`` on one trained
model.  The JAX side runs its ``jnp`` rasterizer; its train() bins with the
"packed" sort and the port's with the exact one, so whole runs are held to
tolerances, not bit equality."""
import json
import os
import pickle
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.cli import render_gaussians as j_render
from gaussianhaircut_tpu.cli import train_gaussians as j_train
from gaussianhaircut_tpu.config import ModelConfig as JModelConfig
from gaussianhaircut_tpu.ops.rasterize import RasterConfig as JRasterConfig
from gaussianhaircut_tpu.scene import dataset as j_dataset
from gaussianhaircut_tpu.scene import ply as j_ply
from gaussianhaircut_tpu.scene.cameras import CameraBatch as JCameraBatch
from gaussianhaircut_tpu.train import stage1 as j_stage1
from gaussianhaircut_torch.cli import render_gaussians as t_render
from gaussianhaircut_torch.cli import train_gaussians as t_train
from gaussianhaircut_torch.config import ModelConfig
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.scene import dataset
from gaussianhaircut_torch.scene.cameras import CameraBatch
from gaussianhaircut_torch.scene.synthetic import bench_scene, write_colmap_scene
from gaussianhaircut_torch.train import stage1
from gaussianhaircut_torch.utils.image import read_png

ITERS = 3
ARGS = ["--sh_degree", "1", "--lambda_dorient", "0.1", "--gaussian_capacity", "256",
        "--iterations", str(ITERS), "--test_iterations", str(ITERS),
        "--save_iterations", str(ITERS), "--checkpoint_iterations", str(ITERS)]
RUN_TOL = dict(rtol=1e-3, atol=1e-5)
ROTATION_LR = 0.001          # OptimizationConfig.rotation_lr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both train CLIs on one written scene.  The JAX logger's optional
    TensorBoard mirror is kept from importing (it pulls in TensorFlow)."""
    root = str(tmp_path_factory.mktemp("cli"))
    scene = os.path.join(root, "scene")
    write_colmap_scene(bench_scene(150, 64, 48, 2, seed=11), scene)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        common = ["-s", scene] + ARGS
        j_train.main(common + ["-m", os.path.join(root, "jax"), "--raster_backend", "jnp"])
        state = t_train.main(common + ["-m", os.path.join(root, "port"), "--device", "cpu"])
    finally:
        mp.undo()
    return dict(root=root, scene=scene, jax=os.path.join(root, "jax"),
                port=os.path.join(root, "port"), state=state)


def _evals(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    return next(r for r in recs if "train_psnr" in r)


def test_train_cli_matches_jax(runs):
    """Three iterations of each CLI: the raw_point_cloud.ply fields and the
    evaluation report agree within rtol 1e-3 (atol 1e-5); both wrote the
    same files, configs with the same keys and camera pickles of numpy
    arrays."""
    sub = f"point_cloud/iteration_{ITERS}/raw_point_cloud.ply"
    ours = j_ply.read_ply(os.path.join(runs["port"], sub))["vertex"]
    ref = j_ply.read_ply(os.path.join(runs["jax"], sub))["vertex"]
    assert ours.dtype.names == ref.dtype.names and len(ours) == len(ref)
    assert len(ours) == runs["state"].model.num_alive()
    for name in ref.dtype.names:
        tol = RUN_TOL
        if name.startswith("rot_"):
            # the initial scales are isotropic, so the rotation gradient is
            # zero analytically and Adam turns its rounding noise into
            # steps of +-lr: up to 2 x lr apart per iteration
            tol = dict(rtol=0.0, atol=2 * ROTATION_LR * ITERS)
        np.testing.assert_allclose(ours[name], ref[name], err_msg=name, **tol)
    e_ours, e_ref = _evals(runs["port"]), _evals(runs["jax"])
    for key in ("train_l1", "train_ce", "train_or", "train_psnr", "total_points"):
        np.testing.assert_allclose(e_ours[key], e_ref[key], rtol=1e-3, err_msg=key)
    for f in (f"checkpoints/{ITERS}.npz", f"cameras/{ITERS}.pkl",
              f"cameras/{ITERS}_matrices.pkl", f"point_cloud/iteration_{ITERS}/point_cloud.ply"):
        assert os.path.exists(os.path.join(runs["port"], f)), f
    with open(os.path.join(runs["port"], "cfg_args.json")) as f:
        cfg_ours = json.load(f)
    with open(os.path.join(runs["jax"], "cfg_args.json")) as f:
        cfg_ref = json.load(f)
    assert set(cfg_ours["model"]) == set(cfg_ref["model"])
    assert set(cfg_ours["optim"]) == set(cfg_ref["optim"])
    assert set(cfg_ref["pipeline"]) - set(cfg_ours["pipeline"]) == {
        "raster_backend", "instance_capacity_mult"}
    with open(os.path.join(runs["port"], "cameras", f"{ITERS}.pkl"), "rb") as f:
        rot, trans, fov = pickle.load(f)
    assert all(type(v) is np.ndarray for d in (rot, trans, fov) for v in d.values())
    images = os.listdir(os.path.join(runs["port"], "images"))
    assert len(images) == len(os.listdir(os.path.join(runs["jax"], "images"))) > 0


def test_evaluate_matches_jax(runs):
    """evaluate() of both packages on the JAX run's checkpoint, each loaded
    by its own package (JAX rasterizer: jnp): L1, mask L1, orientation loss
    and PSNR within rtol 1e-3."""
    ckpt = os.path.join(runs["jax"], "checkpoints", f"{ITERS}.npz")
    jscene = j_dataset.load_scene(JModelConfig(source_path=runs["scene"]))
    tscene = dataset.load_scene(ModelConfig(source_path=runs["scene"]))
    jcams, tcams = jscene.train_cameras, tscene.train_cameras
    idx = [1, 0, 1]
    ref = j_stage1.evaluate(
        j_stage1.load_checkpoint(ckpt), jcams, JCameraBatch.from_cameras(jcams),
        j_stage1.GtBatch.from_cameras(jcams), idx, active_sh_degree=0, width=64, height=48,
        raster_cfg=JRasterConfig(tile_w=32, tile_h=32, backend="jnp"),
        model_cfg=JModelConfig(), name="train")
    got = stage1.evaluate(
        stage1.load_checkpoint(ckpt, "cpu"), tcams, CameraBatch.from_cameras(tcams, "cpu"),
        stage1.GtBatch.from_cameras(tcams, "cpu"), idx, active_sh_degree=0, width=64,
        height=48, raster_cfg=RasterConfig(tile_w=32, tile_h=32), model_cfg=ModelConfig(),
        name="train")
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-3, err_msg=k)


def test_render_cli_matches_jax(runs):
    """Both render_gaussians CLIs on the JAX-trained model: every exported
    PNG within one level (1/255), orient_confs within rtol 1e-4 (atol 1e-6),
    and the exported camera matrices and parameters alike."""
    j_dir, t_dir = runs["jax"], os.path.join(runs["root"], "port_render")
    shutil.copytree(j_dir, t_dir)
    common = ["-s", runs["scene"], "--sh_degree", "1"]
    j_render.main(common + ["-m", j_dir, "--raster_backend", "jnp"])
    t_render.main(common + ["-m", t_dir, "--device", "cpu"])
    out = f"train/ours_{ITERS}"
    kinds = sorted(os.listdir(os.path.join(j_dir, out)))
    assert kinds == sorted(os.listdir(os.path.join(t_dir, out))) and len(kinds) == 7
    for kind in kinds:
        names = sorted(os.listdir(os.path.join(j_dir, out, kind)))
        assert names == sorted(os.listdir(os.path.join(t_dir, out, kind))) and len(names) == 2
        for name in names:
            a, b = (os.path.join(d, out, kind, name) for d in (t_dir, j_dir))
            if name.endswith(".npy"):
                np.testing.assert_allclose(np.load(a), np.load(b), rtol=1e-4, atol=1e-6)
            else:
                diff = np.abs(read_png(a).astype(int) - read_png(b).astype(int))
                assert diff.max() <= 1, (kind, name, diff.max())
    for f in (f"{ITERS}_matrices.pkl", f"{ITERS}_params.pkl"):
        with open(os.path.join(t_dir, "cameras", f), "rb") as fh:
            ours = pickle.load(fh)
        with open(os.path.join(j_dir, "cameras", f), "rb") as fh:
            ref = pickle.load(fh)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            if isinstance(ref[k], dict):
                for key in ref[k]:
                    np.testing.assert_allclose(ours[k][key], ref[k][key], rtol=1e-5,
                                               atol=1e-6, err_msg=key)
            else:
                np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flags, match", [
    # a mesh of two ranks needs two processes: without a launcher the CLI
    # names the launch command
    (["--mesh", "2x1"], "torch.distributed.run --nproc_per_node=2"),
])
def test_train_cli_refuses_unported_options(tmp_path, monkeypatch, flags, match):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match=match):
        t_train.main(["-s", str(tmp_path), "-m", str(tmp_path), "--device", "cpu"] + flags)


@pytest.mark.parametrize("flag", ["--raster_backend", "--instance_capacity_mult"])
def test_cli_rejects_jax_only_flags(flag):
    for main in (t_train.main, t_render.main):
        with pytest.raises(SystemExit):
            main(["-s", "x", "-m", "y", flag, "1"])
