"""The port's batched-camera stage-1 path (``rasterize_batched``,
``train_step_batched``, ``train(camera_batch=B)``) against the JAX package's
on the CPU, and against the port's own single-camera path.

Sizes are those of ``tests/test_parallel.py`` and ``tests/test_rasterize.py``:
16x16 tiles, at most 200 points, chunk 32 for the rasterizer; the JAX side
runs the jnp backend.  The step is taken at the loop's configuration
(``tests/test_torch_parallel.py``'s: res 64, four views, 512 slots, SH degree
0 active), from the state the loop starts from, so that the JAX step reuses
the loop's compile.  Tolerances: the rasterizer's are
``tests/test_torch_rasterize.py``'s, the step's and the loop's
``tests/test_parallel.py``'s."""
import concurrent.futures
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.config import OptimizationConfig as JOptConfig
from gaussianhaircut_tpu.ops.rasterize import RasterConfig as JRasterConfig
from gaussianhaircut_tpu.ops.rasterize.api import rasterize_batched as j_rasterize_batched
from gaussianhaircut_tpu.scene.cameras import CameraBatch as JCameraBatch
from gaussianhaircut_tpu.scene.dataset import SceneData
from gaussianhaircut_tpu.models import gaussian_model as j_gm
from gaussianhaircut_tpu.train import stage1 as j_stage1
from gaussianhaircut_torch.ops.rasterize import common as C
from gaussianhaircut_torch.ops.rasterize import cuda_core, plain_core
from gaussianhaircut_torch.ops.rasterize.api import (
    ndc_xy_to_pixel, rasterize, rasterize_batched,
)
from gaussianhaircut_torch.train import stage1

from tests.test_torch_parallel import (
    CAM_TOL, COMMON, DENSIFY, METRIC_TOL, N_PTS, N_VIEWS, OPT, PARAM_TOL, _batch, _carry,
    _loop_configs, _port_kw, _toy,
)
from tests.test_torch_rasterize import BWD_TOL, FWD_TOL
from tests.exact_skip import jax_3sigma_binning

W, H, P, B = 48, 40, 96, 3          # image, Gaussians per camera, cameras
TILE, CHUNK = 16, 32
RES, LOOP_ITERS, EXTENT = 64, 3, 2.75
STEP_CAMS = [0, 2]
# the loop's flags (ModelConfig's defaults), SH degree 0 active as in the
# loop's first 1,000 iterations
STEP_FLAGS = dict(COMMON, active_sh_degree=0)
BG = np.array([1, 1, 1, 0, 0, 0, 0, 0, 0, 100], np.float32)


def make_cameras(rng, b=B, p=P, width=W, height=H):
    """b cameras' rasterizer inputs ([b, p, ...] numpy): random Gaussians
    around each image, some near-culled (depth 0.1), some invalid."""
    mean_pix = rng.uniform([-5, -5], [width + 5, height + 5], size=(b, p, 2))
    theta = rng.uniform(0, np.pi, (b, p))
    s1, s2 = rng.uniform(1.0, 16.0, (2, b, p))
    c, s = np.cos(theta), np.sin(theta)
    cov = np.stack([c * c * s1 + s * s * s2, c * s * s1 - s * c * s2,
                    s * s * s1 + c * c * s2], -1)
    det = cov[..., 0] * cov[..., 2] - cov[..., 1] ** 2
    conic = np.stack([cov[..., 2] / det, -cov[..., 1] / det, cov[..., 0] / det], -1)
    colors = rng.uniform(0, 1, size=(b, p, 10))
    opacity = rng.uniform(0.05, 1.0, size=(b, p, 1))
    depth = rng.uniform(0.5, 10.0, size=(b, p))
    depth[:, : p // 8] = 0.1
    valid = np.ones((b, p), bool)
    valid[:, p // 8: p // 4] = False
    return _with_ndc(mean_pix, conic, colors, opacity, depth, valid, width, height)


def _with_ndc(mean_pix, conic, colors, opacity, depth, valid, width, height):
    ndc_xy = (2.0 * mean_pix + 1.0) / np.array([width, height]) - 1.0
    ndc = np.concatenate([ndc_xy, np.zeros_like(ndc_xy[..., :1])], -1)
    f32 = lambda x: np.asarray(x, np.float32)
    return f32(ndc), f32(conic), f32(colors), f32(opacity), f32(depth), valid


def _port_grads(cams, weight, cfg, batched=True):
    """(outputs, gradients w.r.t. ndc, conic, colors, opacity, bg) of the
    loss sum(weight * render) + sum(final_T): one batched call, or one
    rasterize call per camera (outputs and gradients stacked)."""
    ndc, conic, colors, opacity, depth, valid = cams
    leaves = [torch.tensor(x, requires_grad=True) for x in (ndc, conic, colors, opacity)]
    bg = torch.tensor(BG, requires_grad=True)
    w = torch.from_numpy(weight)
    if batched:
        out = rasterize_batched(*leaves, torch.from_numpy(depth), torch.from_numpy(valid),
                                bg, W, H, cfg)
        loss = (out["render"] * w).sum() + out["final_T"].sum()
        return out, [g.numpy() for g in torch.autograd.grad(loss, leaves + [bg])]
    outs, grads = [], []
    for b in range(ndc.shape[0]):
        one = [torch.tensor(x[b], requires_grad=True) for x in (ndc, conic, colors, opacity)]
        bg_b = torch.tensor(BG, requires_grad=True)
        out = rasterize(*one, torch.from_numpy(depth[b]), torch.from_numpy(valid[b]), bg_b,
                        W, H, cfg)
        loss = (out["render"] * w[b]).sum() + out["final_T"].sum()
        outs.append(out)
        grads.append([g.numpy() for g in torch.autograd.grad(loss, one + [bg_b])])
    stacked = {k: torch.stack([o[k] for o in outs]) for k in ("render", "final_T", "radii",
                                                             "visibility")}
    for k in ("num_rendered", "num_rendered_3sigma"):
        stacked[k] = sum(o[k] for o in outs)
    stacked["num_rendered_bound"] = len(outs) * max(o["num_rendered"] for o in outs)
    per_cam = [np.stack(g) for g in zip(*grads)]
    per_cam[-1] = per_cam[-1].sum(0)                     # bg: one leaf for all cameras
    return stacked, per_cam


@pytest.fixture(scope="module")
def raster_inputs():
    cams = make_cameras(np.random.default_rng(11))
    weight = np.random.default_rng(12).normal(size=(B, 10, H, W)).astype(np.float32)
    return cams, weight


@pytest.fixture(scope="module")
def runs(raster_inputs):
    """The JAX side of every case, compiled in threads: rasterize_batched at
    B=3 with its gradients, train_step_batched at B=2 from the carried
    state, and train(camera_batch=2) for LOOP_ITERS iterations; all with
    the JAX package's 3-sigma binning, whose pairs the port's exact skip
    composites."""
    cams, weight = raster_inputs
    jcfg = JRasterConfig(tile_w=TILE, tile_h=TILE, chunk=CHUNK, capacity_mult=24,
                         sort_mode="exact", backend="jnp")
    ndc, conic, colors, opacity, depth, valid = cams

    @jax.jit
    def jax_raster(ndc, conic, colors, opacity, bg):
        def loss(ndc, conic, colors, opacity, bg):
            out = j_rasterize_batched(ndc, conic, colors, opacity, jnp.asarray(depth),
                                      jnp.asarray(valid), bg, W, H, jcfg)
            return (jnp.sum(out["render"] * jnp.asarray(weight))
                    + jnp.sum(out["final_T"]), out)
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            ndc, conic, colors, opacity, bg)
        return out, grads

    jcams, tcams, pts, cols = _toy(RES, seed=4)
    model_cfg, opt_cfg, pipe_cfg = _loop_configs(True, LOOP_ITERS)
    jstate = j_stage1.init_train_state(
        j_gm.create_from_pcd(pts, cols, pipe_cfg.gaussian_capacity, model_cfg.sh_degree,
                             EXTENT), N_VIEWS, use_barf=True)
    jhist = []

    def jax_loop_then_step():
        # the loop's first step compiles train_step_batched at the arguments
        # the step below passes, so the step reuses that compile
        j_stage1.train(model_cfg, opt_cfg, pipe_cfg,
                       SceneData(train_cameras=jcams, test_cameras=[], points=pts,
                                 colors=cols, cameras_extent=EXTENT),
                       test_iterations=(), save_iterations=(), checkpoint_iterations=(),
                       camera_batch=2, progress_callback=lambda it, st, m: jhist.append(
                           (it, float(m["total"]), np.asarray(st.cam_opt.count).copy())))
        return jax.block_until_ready(j_stage1.train_step_batched(
            jstate, JCameraBatch.from_cameras(jcams), j_stage1.GtBatch.from_cameras(jcams),
            jnp.asarray(STEP_CAMS, jnp.int32), width=RES, height=RES,
            raster_cfg=JRasterConfig(tile_w=pipe_cfg.tile, tile_h=pipe_cfg.tile,
                                     capacity_mult=pipe_cfg.instance_capacity_mult,
                                     backend=pipe_cfg.raster_backend),
            opt_cfg=opt_cfg, n_batch=len(STEP_CAMS), **STEP_FLAGS))

    with jax_3sigma_binning(), concurrent.futures.ThreadPoolExecutor(2) as pool:
        step = pool.submit(jax_loop_then_step)
        jout, jgrads = jax_raster(*(jnp.asarray(x) for x in (ndc, conic, colors, opacity, BG)))
        jstep = step.result()
    scene = types.SimpleNamespace(train_cameras=tcams, points=pts, colors=cols,
                                  cameras_extent=EXTENT)
    return types.SimpleNamespace(
        jraster=({k: np.asarray(v) for k, v in jout.items()}, [np.asarray(g) for g in jgrads]),
        jstep=jstep, jhist=jhist, tstate=_carry(jstate), tcams=tcams, loop_scene=scene)


def test_rasterize_batched_matches_jax(raster_inputs, runs):
    """B=3: the forward and the gradients of a seeded weighted sum w.r.t.
    ndc, conic, colors, opacity and bg against the JAX package's
    rasterize_batched (jnp backend, 3-sigma binning), and the 3-sigma
    instance count."""
    cams, weight = raster_inputs
    out, grads = _port_grads(cams, weight, C.RasterConfig(tile_w=TILE, tile_h=TILE,
                                                           chunk=CHUNK))
    jout, jgrads = runs.jraster
    assert out["render"].shape == (B, 10, H, W) and out["final_T"].shape == (B, H, W)
    np.testing.assert_allclose(out["render"].detach().numpy(), jout["render"], **FWD_TOL)
    np.testing.assert_allclose(out["final_T"].detach().numpy(), jout["final_T"],
                               rtol=5e-4, atol=1e-4)
    np.testing.assert_array_equal(out["radii"].numpy(), jout["radii"])
    np.testing.assert_array_equal(out["visibility"].numpy(), jout["visibility"])
    assert out["num_rendered_3sigma"] == int(jout["num_rendered"]) >= out["num_rendered"]
    for a, b, name in zip(grads, jgrads, ["ndc", "conic", "colors", "opacity", "bg"]):
        np.testing.assert_allclose(a, b, **BWD_TOL, err_msg=name)


def test_rasterize_batched_matches_single_calls(raster_inputs):
    """B=3 against three rasterize calls: every output bit for bit, the
    instance counts (B x the largest camera's count for the bound), the
    gradients within rtol 1e-6 / atol 1e-6 x the largest entry (the float64
    segment scan runs over one longer stream)."""
    cams, weight = raster_inputs
    cfg = C.RasterConfig(tile_w=TILE, tile_h=TILE, chunk=CHUNK)
    out, grads = _port_grads(cams, weight, cfg)
    ref, ref_grads = _port_grads(cams, weight, cfg, batched=False)
    for k in ("render", "final_T", "radii", "visibility"):
        assert torch.equal(out[k], ref[k]), k
    for k in ("num_rendered", "num_rendered_3sigma", "num_rendered_bound"):
        assert out[k] == ref[k], k
    for a, b, name in zip(grads, ref_grads, ["ndc", "conic", "colors", "opacity", "bg"]):
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(), err_msg=name)


def _tall(ys, width=W, height=H):
    """One tall, opaque Gaussian per camera, centred at pixel row ys[b]
    (sigma 40 px vertically, 3 horizontally), deep enough to pass the near
    plane; its footprint reaches far past its own image's rows."""
    b = len(ys)
    mean_pix = np.stack([np.full(b, width / 2), np.asarray(ys, float)], -1)[:, None]
    conic = np.tile([1 / 9.0, 0.0, 1 / 1600.0], (b, 1, 1))
    colors = np.tile(np.arange(1, 11) / 10.0, (b, 1, 1))
    return _with_ndc(mean_pix, conic, colors, np.full((b, 1, 1), 0.99),
                     np.full((b, 1), 2.0), np.ones((b, 1), bool), width, height)


def test_footprint_stays_in_its_image():
    """A tall footprint at the bottom row of camera 0 and one at the top row
    of camera 1 stay in their own images: camera b's instances lie in its
    own tiles, and each image equals its single render.  Shifting the rect
    before the clamp would hand camera 0's Gaussian to camera 1's top tiles
    and camera 1's to camera 0's bottom ones."""
    cfg = C.RasterConfig(tile_w=TILE, tile_h=TILE, chunk=CHUNK)
    ndc, conic, colors, opacity, depth, valid = (torch.from_numpy(x)
                                                 for x in _tall([H - 1, 0]))
    t_img = cfg.grid(W, H)[0] * cfg.grid(W, H)[1]
    mean_pix = ndc_xy_to_pixel(ndc.reshape(2, 3), W, H)
    flat = lambda x: x.reshape((2,) + tuple(x.shape[2:]))
    pre = C.preprocess(mean_pix, flat(conic), flat(depth), flat(valid), W, H, cfg,
                       opacity=flat(opacity))
    binned = C.bin_instances(pre, mean_pix, flat(conic), flat(opacity), flat(colors),
                             flat(depth), W, H, cfg, n_batch=2)
    assert binned.num_tiles == 2 * t_img and binned.num_rendered == int(pre.tiles_touched.sum())
    for cam in range(2):
        used = binned.gid[binned.tile_of_chunk.long() // t_img != cam]
        assert not (used == cam).any(), f"camera {cam}'s Gaussian in another image's tiles"
        assert (binned.gid == cam).sum() == pre.tiles_touched[cam] > 1
    out = rasterize_batched(ndc, conic, colors, opacity, depth, valid, torch.from_numpy(BG),
                            W, H, cfg)
    for cam in range(2):
        one = rasterize(ndc[cam], conic[cam], colors[cam], opacity[cam], depth[cam],
                        valid[cam], torch.from_numpy(BG), W, H, cfg)
        assert torch.equal(out["render"][cam], one["render"]), cam
        # the footprint spans the whole image's height
        assert (one["final_T"][[0, H - 1], W // 2] < 0.5).all(), cam


def _step_kw():
    """The port's step keywords at the loop's configuration."""
    model_cfg, opt_cfg, pipe_cfg = _loop_configs(False, LOOP_ITERS)
    return dict(_port_kw(RES), **STEP_FLAGS, opt_cfg=opt_cfg,
                raster_cfg=C.RasterConfig(tile_w=pipe_cfg.tile, tile_h=pipe_cfg.tile))


def test_train_step_batched_matches_jax(runs):
    """B=2 from the state carried across: the JAX batched step's metrics,
    parameters, camera rows and densify statistics within
    tests/test_parallel.py's tolerances."""
    cb, gt, _ = _batch(runs.tcams)
    ts, tm = stage1.train_step_batched(runs.tstate, cb, gt, STEP_CAMS, **_step_kw())
    js, jm = runs.jstep
    assert bool(tm["grads_ok"]) and bool(jm["grads_ok"])
    for k in ("l1", "ssim", "mask", "orient", "total"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **METRIC_TOL, err_msg=k)
    assert tm["num_rendered_3sigma"] == int(jm["num_rendered"]) >= tm["num_rendered"]
    for name in ("xyz", "opacity", "scaling", "features_dc"):
        np.testing.assert_allclose(getattr(ts.model.params, name).numpy(),
                                   np.asarray(getattr(js.model.params, name)), **PARAM_TOL,
                                   err_msg=name)
    for name in ("rotation", "translation", "fov"):
        np.testing.assert_allclose(getattr(ts.cam_res, name).numpy(),
                                   np.asarray(getattr(js.cam_res, name)), **CAM_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(ts.model.aux.xyz_grad_accum.numpy(),
                               np.asarray(js.model.aux.xyz_grad_accum), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(ts.model.aux.denom.numpy(), np.asarray(js.model.aux.denom),
                               atol=1e-6)
    np.testing.assert_allclose(ts.model.aux.max_radii2d.numpy(),
                               np.asarray(js.model.aux.max_radii2d), atol=1e-5)
    np.testing.assert_array_equal(ts.cam_opt.count.numpy(), np.asarray(js.cam_opt.count))
    assert ts.step == int(js.step) == 1
    assert ts.model.aux.denom.max() == 2          # seen by both cameras


@pytest.mark.parametrize("cam", [1, 3])
def test_train_step_batched_one_camera_is_train_step(runs, cam):
    """B=1 is train_step bit for bit: the whole state (digest) and the
    metrics."""
    cb, gt, _ = _batch(runs.tcams)
    kw = _step_kw()
    ref, rm = stage1.train_step(runs.tstate, cb, gt, cam, **kw)
    got, m = stage1.train_step_batched(runs.tstate, cb, gt, [cam], **kw)
    assert stage1.state_digest(got) == stage1.state_digest(ref)
    assert m["num_rendered"] == rm["num_rendered"]
    assert m["precompute_gaussians"] == rm["precompute_gaussians"] == 0   # the CPU's composition
    assert all(torch.equal(m[k], rm[k]) for k in ("l1", "ssim", "mask", "orient", "total"))


def test_loop_matches_jax(runs):
    """train(camera_batch=2) for LOOP_ITERS iterations (no densification):
    the JAX loop's loss history within rtol 1e-3 and its camera draws (the
    rows each iteration steps: two distinct cameras)."""
    thist = []
    stage1.train(*_loop_configs(False, LOOP_ITERS), runs.loop_scene, test_iterations=(),
                 save_iterations=(), checkpoint_iterations=(), camera_batch=2, device="cpu",
                 progress_callback=lambda it, st, m: thist.append(
                     (it, float(m["total"]), st.cam_opt.count.numpy().copy())))
    assert [h[0] for h in thist] == [h[0] for h in runs.jhist] == list(range(1, LOOP_ITERS + 1))
    np.testing.assert_allclose([h[1] for h in thist], [h[1] for h in runs.jhist], rtol=1e-3)
    prev_t = prev_j = np.zeros(N_VIEWS, np.int32)
    for (it, _, ct), (_, _, cj) in zip(thist, runs.jhist):
        np.testing.assert_array_equal(ct - prev_t, cj - prev_j, err_msg=f"iteration {it}")
        assert (ct - prev_t).sum() == 2 and (ct - prev_t).max() == 1
        prev_t, prev_j = ct, cj


def test_loop_with_densify(runs):
    """tests/test_parallel.py's camera-batch loop configuration: 8
    iterations, densification at 3 and 6, capacity 512: finite, step 8, and
    the densification added Gaussians."""
    scene = runs.loop_scene
    model_cfg, opt_cfg, pipe_cfg = _loop_configs(False, 8, **dict(
        DENSIFY, densify_until_iter=7))
    launches = dict(cuda_core.launches)
    state = stage1.train(model_cfg, opt_cfg, pipe_cfg, scene, test_iterations=(),
                         save_iterations=(), checkpoint_iterations=(), camera_batch=2,
                         device="cpu")
    assert state.step == 8
    assert bool(torch.isfinite(state.model.params.xyz).all())
    assert state.model.num_alive() > N_PTS
    assert int(state.cam_opt.count.sum()) == 16
    assert cuda_core.launches == launches         # the CPU runs the plain versions


def _refusal(case):
    if case in ("batch_over_cameras", "batch_with_mesh"):
        scene = types.SimpleNamespace(train_cameras=_toy(RES)[1], points=None)
        cfgs = _loop_configs(False, 1)
        kw = ({"camera_batch": N_VIEWS + 1} if case == "batch_over_cameras"
              else {"camera_batch": 2, "mesh_spec": "2x1"})
        return lambda: stage1.train(*cfgs, scene, device="cpu", **kw)
    if case == "repeated_camera":
        return lambda: stage1.train_step_batched(None, None, None, [1, 1], **_step_kw())
    # a kernel grid of two images with its origin moved down a tile row
    cfg = C.RasterConfig(tile_w=TILE, tile_h=TILE, chunk=CHUNK)
    n = 2 * cfg.grid(W, H)[0] * cfg.grid(W, H)[1]
    lay = (torch.zeros((n, C.PAYLOAD_ROWS, CHUNK)), torch.arange(n, dtype=torch.int32),
           torch.ones(n, dtype=torch.int32))
    return lambda: cuda_core.raster_fwd(*lay, W, H, cfg, row0=TILE)


@pytest.mark.parametrize("case", ["batch_over_cameras", "batch_with_mesh", "repeated_camera",
                                  "kernel_batch_with_row0"])
def test_refusals(case):
    """ValueError for more cameras per batch than the scene has, a batch
    with a mesh, a camera twice in one batch, and a kernel grid that is
    both a batch and a row window."""
    with pytest.raises(ValueError):
        _refusal(case)()


def test_plain_kernels_take_the_camera_local_row():
    """The plain versions' pixel rows follow the kernels' tile_origin rule
    (tile // gx) % gy: a two-image layout composites, culls and
    differentiates each image as the one-image layout does."""
    cfg = C.RasterConfig(tile_w=TILE, tile_h=TILE, chunk=CHUNK)
    ndc, conic, colors, opacity, depth, valid = (torch.from_numpy(x[0]) for x in
                                                 make_cameras(np.random.default_rng(5), 1))
    mean_pix = ndc_xy_to_pixel(ndc, W, H)
    pre = C.preprocess(mean_pix, conic, depth, valid, W, H, cfg, opacity=opacity)
    one = C.bin_instances(pre, mean_pix, conic, opacity, colors, depth, W, H, cfg)
    two_pre = C.Preprocessed(*(torch.cat([x, x]) for x in pre[:3]),
                             tuple(torch.cat([x, x]) for x in pre.rect), torch.cat([pre.valid] * 2),
                             torch.cat([pre.tiles_3sigma] * 2))
    cat = lambda x: torch.cat([x, x])
    two = C.bin_instances(two_pre, cat(mean_pix), cat(conic), cat(opacity), cat(colors),
                          cat(depth), W, H, cfg, n_batch=2)
    assert two.num_rendered == 2 * one.num_rendered == two.num_rendered_bound
    assert two.num_rendered_3sigma == 2 * one.num_rendered_3sigma
    lay1 = (one.payload, one.chunk_start, one.nchunks)
    lay2 = (two.payload, two.chunk_start, two.nchunks)
    buf1 = cuda_core.raster_fwd(*lay1, W, H, cfg)
    buf2 = cuda_core.raster_fwd(*lay2, W, H, cfg)
    assert buf1.abs().max() > 0 and torch.equal(buf2, torch.cat([buf1, buf1]))
    gbuf = torch.randn(buf1.shape, generator=torch.Generator().manual_seed(6))
    d1 = cuda_core.raster_bwd(*lay1, buf1, gbuf, W, H, cfg)
    d2 = cuda_core.raster_bwd(*lay2, buf2, torch.cat([gbuf, gbuf]), W, H, cfg)
    m1 = cuda_core.warp_masks(*lay1, W, H, cfg)
    m2 = cuda_core.warp_masks(*lay2, W, H, cfg)
    t1 = one.tile_of_chunk.long()
    for t in range(one.num_tiles):
        c1 = torch.nonzero((t1 == t) & (one.chunk_in_tile >= 0))[:, 0]
        c2 = torch.nonzero((two.tile_of_chunk.long() == t + one.num_tiles)
                           & (two.chunk_in_tile >= 0))[:, 0]
        assert torch.equal(d2[c2], d1[c1]) and torch.equal(m2[c2], m1[c1]), t
    # without the modulo, the second image's pixels would be rows H.. of
    # one tall image: its masks would differ
    flat = plain_core.warp_masks_plain(*lay2, W, cfg, grid_y=2 * cfg.grid(W, H)[1])
    assert not torch.equal(flat, m2)
