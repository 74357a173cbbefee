"""The port's multi-device stage-1 step (``gaussianhaircut_torch/parallel``)
against the JAX package's mesh steps on the CPU.

The toy scene is ``tests/test_stage1.make_toy_scene`` (res 128, 4 views,
200 points) with the ground truth of ``tests/test_parallel.py``; the JAX
state is carried across.  The JAX side runs ``dp_train_step`` /
``dp_tp_train_step`` on the 8 virtual CPU devices of ``conftest.py`` with
the jnp backend; the port side runs D*T processes (torch.multiprocessing
spawn, gloo on the CPU, a FileStore rendezvous under ``tmp_path``), each
rank on the kernels' plain versions, in ``tools/mesh_check.run_jobs``, a
module without JAX.  The other processes (the ranks, the CLI under
torch.distributed.run, two processes building the kernels) start before the JAX side
compiles, so they overlap.  Tolerances are ``tests/test_parallel.py``'s."""
import concurrent.futures
import json
import math
import os
import pickle
import subprocess
import sys
import textwrap
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
from gaussianhaircut_tpu.parallel import (
    dp_tp_train_step as j_dp_tp, dp_train_step as j_dp, make_camera_mesh, make_mesh2d,
)
from gaussianhaircut_tpu.scene.cameras import CameraBatch as JCameraBatch
from gaussianhaircut_tpu.scene.dataset import SceneData
from gaussianhaircut_tpu.train import stage1 as j_stage1
from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.parallel import dp_tp_train_step, dp_train_step
from gaussianhaircut_torch.parallel import mesh as mesh_mod
from gaussianhaircut_torch.parallel.tile_parallel import render_window, row_windows
from gaussianhaircut_torch.render.renderer import default_background, render
from gaussianhaircut_torch.scene.cameras import CameraStatic, camera_geom
from gaussianhaircut_torch.tools import mesh_check
from gaussianhaircut_torch.train import stage1

from tests.exact_skip import jax_3sigma_binning
from tests.test_stage1 import make_toy_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, N_VIEWS, N_PTS, CAP = 128, 4, 200, 256
LOOP_RES, LOOP_ITERS = 64, 3
OPT = dict(lambda_dorient=0.1)
COMMON = dict(active_sh_degree=1, trainable_cameras=True, trainable_intrinsics=True,
              use_barf=True, white_background=False)
METRIC_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=2e-5)
CAM_TOL = dict(rtol=1e-3, atol=1e-6)
# (make_step, mesh, cameras): each is held against the JAX package's step on
# that mesh, its camera-only step on an n x 1 mesh
STEPS = {"dp-2x1": ("dp", "2x1", [0, 2]), "dp_tp-2x1": ("dp_tp", "2x1", [0, 2]),
         "dp_tp-1x2": ("dp_tp", "1x2", [1]), "dp_tp-2x2": ("dp_tp", "2x2", [1, 3])}


def _toy(res, seed=3):
    """JAX cameras with tests/test_parallel.py's ground truth, the port's
    copies, the points and colours."""
    jcams, pts, cols = make_toy_scene(n_views=N_VIEWS, res=res, n_pts=N_PTS)
    rng = np.random.default_rng(seed)
    for c in jcams:
        c.image = rng.uniform(size=(3, res, res)).astype(np.float32)
        c.mask_hair = np.full((1, res, res), 0.5, np.float32)
        c.mask_body = np.ones((1, res, res), np.float32)
        c.orient_angle = rng.uniform(size=(1, res, res)).astype(np.float32)
        c.orient_conf = np.ones((1, res, res), np.float32)
    tcams = []
    for c in jcams:
        t = CameraStatic(uid=c.uid, colmap_id=c.colmap_id, image_name=c.image_name,
                         width=c.width, height=c.height, colmap_transform=c.colmap_transform,
                         fovx=c.fovx, fovy=c.fovy)
        for k in ("image", "mask_hair", "mask_body", "orient_angle", "orient_conf"):
            setattr(t, k, getattr(c, k))
        tcams.append(t)
    return jcams, tcams, pts, cols


def _carry(jstate) -> stage1.TrainState:
    """A JAX TrainState in the port, through plain numpy dicts."""
    d = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()}
    m = jstate.model
    return stage1.train_state_from_numpy(
        d(m.params), d(m.aux), d(jstate.opt.mu), d(jstate.opt.nu), np.asarray(jstate.opt.count),
        d(jstate.cam_res), d(jstate.cam_opt.mu), d(jstate.cam_opt.nu),
        np.asarray(jstate.cam_opt.count), int(jstate.step),
        active_sh_degree=int(m.active_sh_degree), max_sh_degree=m.max_sh_degree,
        spatial_lr_scale=m.spatial_lr_scale, device="cpu")


def _port_kw(res):
    return dict(COMMON, width=res, height=res, raster_cfg=RasterConfig(tile_w=16, tile_h=16),
                opt_cfg=OptimizationConfig(**OPT))


def _batch(tcams):
    cb = stage1.CameraBatch.from_cameras(tcams, "cpu")
    gt = stage1.GtBatch.from_cameras(tcams, "cpu")
    return cb, gt, {k: v.numpy() for k, v in {**vars(cb), **vars(gt)}.items()}


def _loop_configs(jax_side: bool, iterations: int, **opt):
    """The loop's configurations for either package (res 64, 4 views)."""
    if jax_side:
        return (JModelConfig(sh_degree=1), JOptConfig(iterations=iterations, **OPT, **opt),
                JPipeConfig(raster_backend="jnp", tile=16, instance_capacity_mult=24,
                            gaussian_capacity=512))
    return (ModelConfig(sh_degree=1), OptimizationConfig(iterations=iterations, **OPT, **opt),
            PipelineConfig(tile=16, gaussian_capacity=512))


DENSIFY = dict(densify_from_iter=2, densification_interval=3, densify_until_iter=5,
               opacity_reset_interval=100, densify_grad_threshold=1e-6)


def _stop(ranks, popens):
    """Ends whatever still runs (the launcher passes SIGTERM on to its ranks)."""
    for p in ranks:
        if p.is_alive():
            p.kill()
            p.join()
    for p in popens:
        if p.poll() is None:
            p.terminate()
            p.wait(30)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """Every port job in one spawn of 4 ranks, started first; the JAX steps
    and loop meanwhile; then the ranks' results.  Whatever still runs at the
    fixture's teardown is stopped there."""
    root = tmp_path_factory.mktemp("mesh")
    jcams, tcams, pts, cols = _toy(RES)
    jstate = j_stage1.init_train_state(j_gm.create_from_pcd(pts, cols, CAP, 1, 1.0), N_VIEWS,
                                       use_barf=True)
    tstate = _carry(jstate)
    _, _, batch = _batch(tcams)
    jobs = [{"kind": "step", "make_step": b, "mesh": spec, "cams": cams,
             "state": stage1.checkpoint_arrays(tstate), "batch": batch,
             "step_kw": _port_kw(RES)} for b, spec, cams in STEPS.values()]
    lj, lt, lpts, lcols = _toy(LOOP_RES, seed=4)
    scene = types.SimpleNamespace(train_cameras=lt, points=lpts, colors=lcols,
                                  cameras_extent=2.75)
    jobs.append({"kind": "train", "mesh": "2x2", "kwargs": {},
                 "args": (*_loop_configs(False, LOOP_ITERS), scene)})
    jobs.append({"kind": "train", "mesh": "2x2", "kwargs": {},
                 "args": (*_loop_configs(False, 6, **DENSIFY), scene)})
    ctx = torch.multiprocessing.start_processes(
        mesh_check.run_jobs, args=(str(root), jobs, str(root)), nprocs=4, join=False,
        start_method="spawn")
    cli = _start_cli(root / "cli")
    builds = _start_kernel_builds(root / "build")
    request.addfinalizer(lambda: _stop(ctx.processes, [cli[0], *builds[0]]))

    jcb, jgt = JCameraBatch.from_cameras(jcams), j_stage1.GtBatch.from_cameras(jcams)
    jcfg = JRasterConfig(tile_w=16, tile_h=16, chunk=32, capacity_mult=24, backend="jnp")

    def jax_step(spec, cams):
        n_data, n_tile = (int(v) for v in spec.split("x"))
        if n_tile == 1:
            step = j_dp(make_camera_mesh(jax.devices()[:n_data]), width=RES, height=RES,
                        raster_cfg=jcfg, opt_cfg=JOptConfig(**OPT), **COMMON)
        else:
            step = j_dp_tp(make_mesh2d(n_data, n_tile), width=RES, height=RES,
                           raster_cfg=jcfg, opt_cfg=JOptConfig(**OPT), **COMMON)
        return jax.block_until_ready(step(jstate, jcb, jgt, jnp.asarray(cams, jnp.int32)))

    jhist = []

    def jax_loop():
        j_stage1.train(*_loop_configs(True, LOOP_ITERS),
                       SceneData(train_cameras=lj, test_cameras=[], points=lpts,
                                 colors=lcols, cameras_extent=2.75),
                       test_iterations=(), save_iterations=(), checkpoint_iterations=(),
                       mesh_spec="2x2", progress_callback=lambda it, st, m: jhist.append(
                           (it, float(m["total"]), np.asarray(st.cam_opt.count).copy())))

    # the JAX compiles overlap in threads (XLA compiles outside the GIL); the
    # JAX side bins the 3-sigma rect, whose pairs the port's exact skip
    # composites (tests/exact_skip.py)
    with jax_3sigma_binning(), concurrent.futures.ThreadPoolExecutor(4) as pool:
        meshes = {(spec, tuple(cams)) for _, spec, cams in STEPS.values()}
        futures = {m: pool.submit(jax_step, m[0], list(m[1])) for m in sorted(meshes)}
        loop = pool.submit(jax_loop)
        jax_steps = {name: futures[spec, tuple(cams)].result()
                     for name, (_, spec, cams) in STEPS.items()}
        loop.result()

    while not ctx.join():
        pass
    cli_out = cli[0].communicate()
    build_rcs = [p.wait() for p in builds[0]]
    port = {}
    for i in range(len(jobs)):
        world = math.prod(int(v) for v in jobs[i]["mesh"].split("x"))
        port[i] = []
        for r in range(world):
            with open(root / f"job{i}_rank{r}.pkl", "rb") as f:
                port[i].append(pickle.load(f))
    return types.SimpleNamespace(jax_steps=jax_steps, jhist=jhist, port=port, tstate=tstate,
                                 tcams=tcams, n_steps=len(STEPS),
                                 cli=(cli[0].returncode, *cli_out, cli[1]),
                                 build=(build_rcs, *builds[1:]))


def _assert_ranks_identical(results):
    first = results[0]["state"]
    for r, res in enumerate(results[1:], 1):
        assert sorted(res["state"]) == sorted(first)
        for k, v in res["state"].items():
            np.testing.assert_array_equal(v, first[k], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("case", list(STEPS))
def test_mesh_step_matches_jax(runs, case):
    """One mesh step from the same state: the JAX mesh step's metrics,
    parameters, camera rows and densify statistics within
    tests/test_parallel.py's tolerances; the ranks bit-identical."""
    i = list(STEPS).index(case)
    results = runs.port[i]
    _assert_ranks_identical(results)
    js, jm = runs.jax_steps[case]
    rec, ts = results[0]["record"], stage1.state_from_arrays(results[0]["state"], "cpu")
    assert rec["metrics"]["grads_ok"] == 1.0 and bool(jm.get("grads_ok", True))
    for k in ("l1", "ssim", "mask", "orient", "total"):
        np.testing.assert_allclose(rec["metrics"][k], float(jm[k]), **METRIC_TOL, err_msg=k)
    for name in ("xyz", "opacity", "scaling", "features_dc"):
        np.testing.assert_allclose(getattr(ts.model.params, name).numpy(),
                                   np.asarray(getattr(js.model.params, name)), **PARAM_TOL,
                                   err_msg=name)
    for name in ("rotation", "translation", "fov"):
        np.testing.assert_allclose(getattr(ts.cam_res, name).numpy(),
                                   np.asarray(getattr(js.cam_res, name)), **CAM_TOL,
                                   err_msg=name)
    # the one statistic a uniform gradient scale shows in (Adam hides it)
    np.testing.assert_allclose(ts.model.aux.xyz_grad_accum.numpy(),
                               np.asarray(js.model.aux.xyz_grad_accum), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(ts.model.aux.denom.numpy(), np.asarray(js.model.aux.denom),
                               atol=1e-6)
    np.testing.assert_allclose(ts.model.aux.max_radii2d.numpy(),
                               np.asarray(js.model.aux.max_radii2d), atol=1e-5)
    np.testing.assert_array_equal(ts.cam_opt.count.numpy(), np.asarray(js.cam_opt.count))
    assert ts.step == int(js.step) == 1
    n = math.prod(int(v) for v in STEPS[case][1].split("x"))
    assert len(results) == n and rec["backend"] == "gloo" and rec["bytes_per_step"] > 0


def test_1x1_equals_train_step(runs):
    """A 1x1 mesh needs no launcher and its step is ``train_step``, bit for
    bit, for both step functions."""
    cb, gt, _ = _batch(runs.tcams)
    kw = _port_kw(RES)
    ref, rm = stage1.train_step(runs.tstate, cb, gt, 2, **kw)
    for make_step, mesh in ((dp_tp_train_step, mesh_mod.make_mesh2d(1, 1, "cpu")),
                          (dp_train_step, mesh_mod.make_camera_mesh(1, "cpu"))):
        assert mesh.backend is None and (mesh.n_data, mesh.n_tile) == (1, 1)
        new, m = make_step(mesh, **kw)(runs.tstate, cb, gt, [2])
        assert stage1.state_digest(new) == stage1.state_digest(ref), make_step.__name__
        assert m["num_rendered"] == rm["num_rendered"]
        assert all(torch.equal(m[k], rm[k]) for k in ("l1", "ssim", "mask", "orient", "total"))


def test_loop_matches_jax(runs):
    """train(mesh_spec="2x2") for 3 iterations (no densification): the
    JAX loop's loss history within rtol 1e-3 and its camera draws (the rows
    each iteration steps); every rank ends bit-identical."""
    results = runs.port[runs.n_steps]
    _assert_ranks_identical(results)
    thist = results[0]["history"]
    assert [h[0] for h in thist] == [h[0] for h in runs.jhist] == list(range(1, LOOP_ITERS + 1))
    np.testing.assert_allclose([h[1] for h in thist], [h[1] for h in runs.jhist], rtol=1e-3)
    prev_t = prev_j = np.zeros(N_VIEWS, np.int32)
    for (it, _, ct), (_, _, cj) in zip(thist, runs.jhist):
        np.testing.assert_array_equal(ct - prev_t, cj - prev_j, err_msg=f"iteration {it}")
        assert (ct - prev_t).sum() == 2          # two cameras per iteration
        prev_t, prev_j = ct, cj
    for res in results[1:]:
        assert [h[1] for h in res["history"]] == [h[1] for h in thist]


def test_loop_with_densify_keeps_ranks_identical(runs):
    """A 6-iteration 2x2 run that densifies once (iteration 3) ends with
    every rank's state bit-identical, and the densification changed it."""
    results = runs.port[runs.n_steps + 1]
    _assert_ranks_identical(results)
    alive = results[0]["state"]["aux.alive"]
    assert alive.sum() > N_PTS, alive.sum()
    assert int(results[0]["state"]["step"]) == 6


@pytest.mark.parametrize("n_tile", [2, 3, 5])
def test_row_windows_equal_full_render(runs, n_tile):
    """``rasterize(..., full_height=H, row0=y0)`` on each tile rank's
    window, stacked and cropped, is one full render: the forward bit for
    bit, the gradients up to the order of the windows' sums (3 windows of
    48 rows at res 128: the last one stops at the image; 5 of 32: the last
    one starts below it and renders nothing)."""
    cb, _, _ = _batch(runs.tcams)
    state = runs.tstate
    params = state.model.params.map(lambda t: t.detach().requires_grad_())
    cam = camera_geom(cb.colmap_transform[1], cb.fovx[1], cb.fovy[1], RES, RES,
                      state.cam_res, 1, use_barf=True)
    cfg = RasterConfig(tile_w=16, tile_h=16)
    bg = default_background(False, "cpu")
    weight = torch.from_numpy(np.random.default_rng(7).normal(size=(10, RES, RES))
                              .astype(np.float32))
    full = render(params, state.model.aux.alive, 1, cam, bg, cfg)["render10"]
    g_full = torch.autograd.grad((full * weight).sum(), params.values(), allow_unused=True)
    crop_h, windows = row_windows(RES, 16, n_tile)
    assert sum(rows for _, rows in windows) == RES
    parts, g_sum = [], None
    for y0, rows in windows:
        win = render_window(params, state.model.aux.alive, 1, cam, bg, cfg, y0, rows, crop_h,
                            RES)[0]
        assert win.shape == (10, crop_h, RES)
        parts.append(win)
        if rows == 0:
            assert not win.requires_grad and not win.any()
            continue
        g = torch.autograd.grad((win[:, :rows] * weight[:, y0:y0 + rows]).sum(),
                                params.values(), allow_unused=True)
        g_sum = g if g_sum is None else [a if b is None else b if a is None else a + b
                                         for a, b in zip(g_sum, g)]
    # the rows are offset in whole pixels, so the windows' pixels are the
    # full render's bit for bit
    assert torch.equal(torch.cat(parts, 1)[:, :RES], full)
    for name, a, b in zip(state.model.params.names(), g_sum, g_full):
        if b is None:
            assert a is None, name
            continue
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("n_tile", [2, 4])
def test_row_windows_exact_for_footprints_across_windows(n_tile):
    """Tall Gaussians centred anywhere -- above the image, or high in an
    upper window, far above a lower window's first row -- whose footprints
    reach lower windows (a 64x544 image, the bench's height: windows of 272
    or 144 rows): every window, ``rasterize(..., full_height=H, row0=y0)``,
    is the full render's rows bit for bit, visibility and radii included,
    and the windows' gradients sum to the full render's.  (Pixel means
    shifted by -y0 would round for some of these Gaussians, and the
    difference from a pixel would round again.)"""
    width, height, p = 64, 544, 32
    rng = np.random.default_rng(11)
    cfg = RasterConfig(tile_w=16, tile_h=16)
    mean = np.stack([rng.uniform(-20, width + 20, p), rng.uniform(-60, height + 60, p)], 1)
    mean[:12, 1] = rng.uniform(-120.0, 60.0, 12)
    sx, sy = rng.uniform(6.0, 30.0, p), rng.uniform(20.0, 150.0, p)
    cxy = rng.uniform(-0.5, 0.5, p) * sx * sy
    det = sx * sx * sy * sy - cxy * cxy
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    size = np.array([width, height])
    ndc = f32(np.concatenate([(2.0 * mean + 1.0) / size - 1.0, np.zeros((p, 1))], 1))
    conic = f32(np.stack([sy * sy / det, -cxy / det, sx * sx / det], 1))
    colors = f32(rng.uniform(size=(p, 10)))
    opacity = f32(rng.uniform(0.1, 0.6, (p, 1)))
    depth = f32(rng.uniform(1.0, 5.0, p))
    valid = torch.ones(p, dtype=torch.bool)
    bg = default_background(False, "cpu")
    leaves = [t.requires_grad_() for t in (ndc, conic, colors, opacity, bg)]
    weight = f32(rng.normal(size=(10, height, width)))
    from gaussianhaircut_torch.ops.rasterize.api import rasterize

    full = rasterize(ndc, conic, colors, opacity, depth, valid, bg, width, height, cfg)
    g_full = torch.autograd.grad((full["render"] * weight).sum(), leaves)
    _, windows = row_windows(height, 16, n_tile)
    g_sum, vis, radii, reached = [0.0] * len(leaves), torch.zeros(p, dtype=torch.bool), 0, 0
    for y0, rows in windows:
        win = rasterize(ndc, conic, colors, opacity, depth, valid, bg, width, rows, cfg,
                        full_height=height, row0=y0)
        assert torch.equal(win["render"], full["render"][:, y0:y0 + rows]), y0
        assert torch.equal(win["final_T"], full["final_T"][y0:y0 + rows]), y0
        g = torch.autograd.grad((win["render"] * weight[:, y0:y0 + rows]).sum(), leaves)
        g_sum = [a + b for a, b in zip(g_sum, g)]
        vis = vis | win["visibility"]
        radii = torch.maximum(torch.as_tensor(radii), win["radii"])
        if y0 > 0:
            reached += int(win["visibility"][:12].sum())
    assert reached >= 3, f"{reached} windows reached by Gaussians centred high up"
    assert torch.equal(vis, full["visibility"]) and torch.equal(radii, full["radii"])
    for name, a, b in zip(("ndc", "conic", "colors", "opacity", "bg"), g_sum, g_full):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)


CLI_ARGS = ["--device", "cpu", "--sh_degree", "1", "--gaussian_capacity", "64",
            "--iterations", "2", "--test_iterations", "2", "--save_iterations", "2",
            "--checkpoint_iterations", "2"]


def _start_cli(root):
    """``train_gaussians --mesh 2x1`` under torch.distributed.run on the CPU,
    on a 2-view scene written to ``root`` -> (process, model directory)."""
    from gaussianhaircut_torch.scene.synthetic import bench_scene, write_colmap_scene
    src, model = os.path.join(root, "scene"), os.path.join(root, "model")
    write_colmap_scene(bench_scene(50, 32, 32, 2), src)
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "gaussianhaircut_torch.cli.train_gaussians", "--mesh", "2x1", "-s", src,
         "-m", model, *CLI_ARGS], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO), model


def test_cli_mesh_under_launcher(runs):
    """``train_gaussians --mesh 2x1`` through torch.distributed.run on the
    CPU: rank 0 alone writes the model directory and the log, and prints
    the ranks' summary with equal state hashes."""
    rc, out, err, model = runs.cli
    assert rc == 0, out[-3000:] + err[-3000:]
    assert out.count("Optimizing") == 1 and out.count("Training complete.") == 1, out
    assert "backend gloo" in out
    summary = [ln for ln in out.splitlines() if ln.startswith("mesh_summary ")]
    assert len(summary) == 1, out
    rec = json.loads(summary[0].split(" ", 1)[1])
    assert rec["mesh"] == "2x1" and rec["steps"] == 2 and len(rec["ranks"]) == 2
    assert all(r["bytes_per_step"] > 0 for r in rec["ranks"])
    for f in ("cfg_args.json", "checkpoints/2.npz", "cameras/2.pkl",
              "point_cloud/iteration_2/point_cloud.ply"):
        assert os.path.exists(os.path.join(model, f)), f
    with open(os.path.join(model, "metrics.jsonl")) as f:
        evals = [ln for ln in f if "train_psnr" in ln]
    assert len(evals) == 1, evals
    assert stage1.load_checkpoint(os.path.join(model, "checkpoints", "2.npz"), "cpu").step == 2


def test_cli_mesh_without_launcher_raises(tmp_path, monkeypatch):
    """``--mesh 2x2`` in a plain process raises with the launch command,
    before reading the scene."""
    from gaussianhaircut_torch.cli import train_gaussians
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run --nproc_per_node=4"):
        train_gaussians.main(["-s", str(tmp_path / "missing"), "-m", str(tmp_path / "m"),
                              "--mesh", "2x2", "--device", "cpu"])
    with pytest.raises(ValueError, match="DATAxTILE"):
        mesh_mod.parse_mesh_spec("2by2")


def _start_kernel_builds(root):
    """Two processes that build the kernels into one empty directory at
    once, with an nvcc stand-in that logs its output path and waits until
    all the compiles (two of each source) have started -> (processes, log,
    build directory)."""
    from gaussianhaircut_torch import kernels
    os.makedirs(root)
    fake, log, build = root / "nvcc", root / "calls", root / "build"
    fake.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import os, sys, time
        out = sys.argv[sys.argv.index("-o") + 1]
        with open({str(log)!r}, "a") as f:
            f.write(out + "\\n")
        t0 = time.time()
        while (len(open({str(log)!r}).read().split()) < {2 * len(kernels.SOURCES)}
               and time.time() - t0 < 60):
            time.sleep(0.05)
        with open(out, "w") as f:
            f.write("lib " + os.path.basename(sys.argv[-1]))
        """))
    fake.chmod(0o755)
    script = textwrap.dedent(f"""
        from gaussianhaircut_torch import kernels
        kernels.BUILD_DIR = {str(build)!r}
        kernels._nvcc = lambda: {str(fake)!r}
        kernels._load = lambda name: None
        kernels.build()
        """)
    env = dict(os.environ, PYTHONPATH=REPO)
    return ([subprocess.Popen([sys.executable, "-c", script], env=env, cwd=REPO)
             for _ in range(2)], log, build)


def test_kernels_build_from_several_processes(runs):
    """Two processes building into one empty directory at once: every nvcc
    run writes a temporary file of its own, and each library lands whole."""
    from gaussianhaircut_torch import kernels
    rcs, log, build = runs.build
    assert rcs == [0, 0]
    calls = log.read_text().split()
    sources = len(kernels.SOURCES)
    assert len(calls) == 2 * sources and len(set(calls)) == 2 * sources, calls
    names = sorted(os.listdir(build))
    assert len(names) == sources and not any(n.endswith(".tmp") for n in names), names
    for name, src in kernels.SOURCES.items():
        lib = os.path.basename(kernels._lib_path(name))
        assert (build / lib).read_text() == "lib " + src
