"""Parity of the port's stage-1 trainer with the JAX package on a toy scene
(200 points, 64x48, two views): one train_step from a state carried across,
densify_and_prune and reset_opacity with the same split samples, and three
iterations of train()."""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.config import (
    ModelConfig as JModelConfig, OptimizationConfig as JOptConfig,
    PipelineConfig as JPipeConfig,
)
from gaussianhaircut_tpu.models import gaussian_model as j_gm
from gaussianhaircut_tpu.ops.rasterize import RasterConfig as JRasterConfig
from gaussianhaircut_tpu.scene.cameras import (
    CameraBatch as JCameraBatch, CameraStatic as JCameraStatic,
)
from gaussianhaircut_tpu.scene.dataset import SceneData
from gaussianhaircut_tpu.train import densify as j_densify
from gaussianhaircut_tpu.train import stage1 as j_stage1
from gaussianhaircut_torch.config import (
    ModelConfig, OptimizationConfig, PipelineConfig,
)
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.scene.cameras import CameraBatch, CameraStatic
from gaussianhaircut_torch.train import densify, stage1

W, H, N_PTS, N_VIEWS, CAP = 64, 48, 200, 2, 256
OPT = dict(lambda_dorient=0.1)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


def _views(rng):
    """Two ring cameras with random ground truth: [(w2c, fov, gt dict)]."""
    out = []
    fov = math.radians(50)
    for i in range(N_VIEWS):
        a = 2 * math.pi * i / N_VIEWS + 0.3
        center = np.array([2.5 * math.sin(a), 0.3, 2.5 * math.cos(a)])
        fwd = -center / np.linalg.norm(center)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 0)
        w2c[:3, 3] = -w2c[:3, :3] @ center
        gt = dict(image=rng.uniform(size=(3, H, W)).astype(np.float32),
                  mask_hair=(rng.uniform(size=(1, H, W)) > 0.5).astype(np.float32),
                  mask_body=np.ones((1, H, W), np.float32),
                  orient_angle=rng.uniform(size=(1, H, W)).astype(np.float32),
                  orient_conf=rng.uniform(0.5, 1.5, size=(1, H, W)).astype(np.float32))
        out.append((w2c, fov, gt))
    return out


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(5)
    pts = rng.normal(scale=0.3, size=(N_PTS, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.9, size=(N_PTS, 3)).astype(np.float32)
    views = _views(rng)

    def cams(cls):
        out = []
        for i, (w2c, fov, gt) in enumerate(views):
            c = cls(uid=i, colmap_id=i, image_name=f"{i:04d}", width=W, height=H,
                    colmap_transform=w2c, fovx=fov, fovy=fov)
            for k, v in gt.items():
                setattr(c, k, v)
            out.append(c)
        return out
    return types.SimpleNamespace(pts=pts, cols=cols, jcams=cams(JCameraStatic),
                                 tcams=cams(CameraStatic), extent=1.2)


def _jax_raster_cfg():
    # the configuration train() builds from PipelineConfig, so that the
    # jitted step compiles once for this file
    p = JPipeConfig(raster_backend="jnp", tile=32, gaussian_capacity=CAP)
    return JRasterConfig(tile_w=p.tile, tile_h=p.tile,
                         capacity_mult=p.instance_capacity_mult,
                         backend=p.raster_backend)


def _to_numpy_state(st):
    """A JAX TrainState as the plain numpy dicts the port takes."""
    d = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()}
    return dict(params=d(st.model.params), aux=d(st.model.aux),
                opt_mu=d(st.opt.mu), opt_nu=d(st.opt.nu), opt_count=np.asarray(st.opt.count),
                cam_res=d(st.cam_res), cam_mu=d(st.cam_opt.mu), cam_nu=d(st.cam_opt.nu),
                cam_count=np.asarray(st.cam_opt.count), step=int(st.step))


def _carry(st, model_state):
    return stage1.train_state_from_numpy(
        **_to_numpy_state(st), active_sh_degree=int(model_state.active_sh_degree),
        max_sh_degree=model_state.max_sh_degree,
        spatial_lr_scale=model_state.spatial_lr_scale, device="cpu")


def _assert_state_close(ts, js, tol, what):
    js_np = _to_numpy_state(js)
    for name in ("params", "opt_mu", "opt_nu"):
        rec = {"params": ts.model.params, "opt_mu": ts.opt.mu, "opt_nu": ts.opt.nu}[name]
        for field in rec.names():
            np.testing.assert_allclose(getattr(rec, field).detach().numpy(),
                                       js_np[name][field], **tol,
                                       err_msg=f"{what}: {name}.{field}")
    for name, rec in (("cam_res", ts.cam_res), ("cam_mu", ts.cam_opt.mu),
                      ("cam_nu", ts.cam_opt.nu)):
        for field in rec.names():
            np.testing.assert_allclose(getattr(rec, field).numpy(), js_np[name][field],
                                       **tol, err_msg=f"{what}: {name}.{field}")
    np.testing.assert_array_equal(ts.opt.count.numpy(), js_np["opt_count"])
    np.testing.assert_array_equal(ts.cam_opt.count.numpy(), js_np["cam_count"])
    np.testing.assert_array_equal(ts.model.aux.alive.numpy(), js_np["aux"]["alive"])


@pytest.fixture(scope="module")
def steps(toy):
    """Two train steps on each side from the same state (the second one
    from the JAX state after the first, carried across again)."""
    jms = j_gm.create_from_pcd(toy.pts, toy.cols, CAP, 3, toy.extent)
    js0 = j_stage1.init_train_state(jms, N_VIEWS, use_barf=True)
    jcb = JCameraBatch.from_cameras(toy.jcams)
    jgt = j_stage1.GtBatch.from_cameras(toy.jcams)
    tcb = CameraBatch.from_cameras(toy.tcams, "cpu")
    tgt = stage1.GtBatch.from_cameras(toy.tcams, "cpu")
    kw = dict(active_sh_degree=0, width=W, height=H, trainable_cameras=True,
              trainable_intrinsics=True, use_barf=True, white_background=False)
    out = []
    js = js0
    for cam_idx in (1, 0):
        ts = _carry(js, jms)
        js_next, jm = j_stage1.train_step(js, jcb, jgt, jnp.asarray(cam_idx),
                                          raster_cfg=_jax_raster_cfg(),
                                          opt_cfg=JOptConfig(**OPT), **kw)
        ts_next, tm = stage1.train_step(ts, tcb, tgt, cam_idx,
                                        raster_cfg=RasterConfig(tile_w=32, tile_h=32),
                                        opt_cfg=OptimizationConfig(**OPT), **kw)
        out.append((js_next, jm, ts_next, tm))
        js = js_next
    return out


@pytest.mark.parametrize("k", [0, 1])
def test_train_step_matches_jax(steps, k):
    js, jm, ts, tm = steps[k]
    for name in ("l1", "ssim", "mask", "orient", "total"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4,
                                   err_msg=name)
    assert tm["num_rendered"] == int(jm["num_rendered"])
    assert bool(tm["grads_ok"]) and bool(jm["grads_ok"])
    _assert_state_close(ts, js, STEP_TOL, f"step {k}")
    for field in ("max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_allclose(getattr(ts.model.aux, field).numpy(),
                                   np.asarray(getattr(js.model.aux, field)),
                                   **STEP_TOL, err_msg=field)


@pytest.mark.parametrize("max_screen_size", [None, 20])
def test_densify_and_reset_match_jax(steps, toy, max_screen_size):
    """Clone, split and prune with the same split samples: exact alive
    masks, parameters and moments within 1e-6; then the opacity reset."""
    js = steps[1][0]
    rng = np.random.default_rng(9)
    # make a mix of clone, split and prune candidates
    accum = np.where(rng.uniform(size=CAP) < 0.3, 1e-3, 0.0).astype(np.float32)
    scaling = np.asarray(js.model.params.scaling) + rng.normal(
        scale=1.5, size=(CAP, 3)).astype(np.float32)
    opacity = np.asarray(js.model.params.opacity) + rng.normal(
        scale=2.0, size=(CAP, 1)).astype(np.float32)
    jmodel = js.model.replace(
        params=js.model.params._replace(scaling=jnp.asarray(scaling),
                                        opacity=jnp.asarray(opacity)),
        aux=js.model.aux._replace(xyz_grad_accum=jnp.asarray(accum),
                                  denom=jnp.ones(CAP, jnp.float32)))
    js = js._replace(model=jmodel)
    ts = _carry(js, jmodel)
    key = jax.random.PRNGKey(3)
    k0, k1 = jax.random.split(key)          # densify.py:98-101
    samples = np.stack([np.asarray(jax.random.normal(k, (CAP, 3))) for k in (k0, k1)])
    args = (2e-4, 0.005, toy.extent, max_screen_size, 0.01)
    jm2, jopt2 = j_densify.densify_and_prune(js.model, js.opt, key, *args)
    tm2, topt2 = densify.densify_and_prune(ts.model, ts.opt, torch.from_numpy(samples),
                                           *args)
    alive = np.asarray(jm2.aux.alive)
    assert 0 < alive.sum() != np.asarray(js.model.aux.alive).sum()
    np.testing.assert_array_equal(tm2.aux.alive.numpy(), alive)
    tol = dict(rtol=0, atol=1e-6)
    js2 = js._replace(model=jm2, opt=jopt2)
    ts2 = stage1.TrainState(tm2, topt2, ts.cam_res, ts.cam_opt, ts.step)
    _assert_state_close(ts2, js2, tol, "densify")

    jm3, jopt3 = j_densify.reset_opacity(jm2, jopt2)
    tm3, topt3 = densify.reset_opacity(tm2, topt2)
    _assert_state_close(stage1.TrainState(tm3, topt3, ts.cam_res, ts.cam_opt, ts.step),
                        js._replace(model=jm3, opt=jopt3), tol, "reset_opacity")


def test_train_three_iterations_match_jax(toy):
    iters = 3
    jhist, thist = [], []
    j_stage1.train(
        JModelConfig(sh_degree=3), JOptConfig(iterations=iters, **OPT),
        JPipeConfig(raster_backend="jnp", tile=32, gaussian_capacity=CAP),
        SceneData(train_cameras=toy.jcams, test_cameras=[], points=toy.pts,
                  colors=toy.cols, cameras_extent=toy.extent),
        test_iterations=(), save_iterations=(), checkpoint_iterations=(),
        progress_callback=lambda it, st, m: jhist.append(float(m["total"])))
    stage1.train(
        ModelConfig(sh_degree=3), OptimizationConfig(iterations=iters, **OPT),
        PipelineConfig(tile=32, gaussian_capacity=CAP),
        types.SimpleNamespace(train_cameras=toy.tcams, points=toy.pts,
                              colors=toy.cols, cameras_extent=toy.extent),
        device="cpu", progress_callback=lambda it, st, m: thist.append(float(m["total"])))
    assert len(thist) == len(jhist) == iters
    assert np.isfinite(thist).all()
    np.testing.assert_allclose(thist, jhist, rtol=1e-3)


def test_restore_reads_jax_capture(toy):
    """A JAX checkpoint dict (gaussian_model.capture) restores in the port,
    and the port's capture round-trips."""
    from gaussianhaircut_torch.models import gaussian_model as t_gm
    jms = j_gm.create_from_pcd(toy.pts, toy.cols, CAP, 3, toy.extent)
    tms = t_gm.restore(j_gm.capture(jms), "cpu")
    again = t_gm.capture(tms)
    for key, ref in j_gm.capture(jms).items():
        np.testing.assert_array_equal(again[key], np.asarray(ref), err_msg=key)
    # the port's own initialisation agrees with the JAX one
    ours = t_gm.capture(t_gm.create_from_pcd(toy.pts, toy.cols, CAP, 3, toy.extent, "cpu"))
    for key, ref in j_gm.capture(jms).items():
        np.testing.assert_allclose(ours[key], np.asarray(ref), rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_resume_keeps_the_checkpoint_capacity(toy, tmp_path):
    """A run resumed from a checkpoint takes its slot capacity from the
    checkpoint, not from the pipeline config: densification after the
    resume draws split samples of the loaded state's capacity."""
    scene = types.SimpleNamespace(train_cameras=toy.tcams, points=toy.pts,
                                  colors=toy.cols, cameras_extent=toy.extent)
    model_cfg = ModelConfig(sh_degree=1, model_path=str(tmp_path))
    stage1.train(model_cfg, OptimizationConfig(iterations=2, **OPT),
                 PipelineConfig(tile=32, gaussian_capacity=CAP), scene,
                 test_iterations=(), save_iterations=(), checkpoint_iterations=(2,),
                 device="cpu")
    opt = OptimizationConfig(iterations=4, densify_from_iter=2,
                             densification_interval=1, **OPT)
    state = stage1.train(ModelConfig(sh_degree=1), opt,
                         PipelineConfig(tile=32, gaussian_capacity=2 * CAP), scene,
                         test_iterations=(), save_iterations=(), checkpoint_iterations=(),
                         start_checkpoint=str(tmp_path / "checkpoints" / "2.npz"),
                         device="cpu")
    assert state.step == 4 and state.model.capacity == CAP
