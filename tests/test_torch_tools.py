"""The port's two record tools against the JAX package's
(``tools/{pipeline_e2e_run,s3_lr_probe}.py``).

- ``pipeline_e2e_run.build_scene`` at 2 views, 64 px, 200 teacher strands of
  16 points, beside the JAX tool's: ``cameras.txt`` and ``images.txt``
  equal, ``points3D.txt`` equal to its printed digits (the same numpy
  draws), every PNG within one level on at least 99.9% of its pixels (the
  two rasterizers differ in the last bits, and ``(x * 255)`` truncates; at
  this size all but a handful of pixels are equal).  The stage-time parser
  turns a fixed ``run_pipeline`` log into the JAX record's keys.
- ``s3_lr_probe`` at 32 px, 2 + 1 views, 16 strands of 8 points, texture 16,
  from a JAX stage-2 checkpoint at the JAX package's ``PRNGKey(1)`` roots:
  its ``init`` test PSNR within 2e-3 dB, hair L1 within 2e-5 (both rounded
  as the tool rounds them, to 3 and 5 decimals) and chamfer within rtol
  1e-4 of the JAX tool's computation; ``main`` writes the JAX tool's keys.
"""
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.models.textured_strands import TexturedStrandsConfig as JScfg
from gaussianhaircut_tpu.models.textured_strands import synthetic_scalp_pool as j_pool
from gaussianhaircut_tpu.ops import losses as JL
from gaussianhaircut_tpu.ops.chamfer import chamfer_distance as j_chamfer
from gaussianhaircut_tpu.ops.rasterize import RasterConfig as JRasterConfig
from gaussianhaircut_tpu.render.renderer import default_background as j_bg
from gaussianhaircut_tpu.render.renderer import render_fields as j_render
from gaussianhaircut_tpu.scene.cameras import camera_geom as j_camera_geom
from gaussianhaircut_tpu.train import stage2 as j_stage2
from gaussianhaircut_tpu.train import stage3 as j_stage3
from gaussianhaircut_torch.tools import pipeline_e2e_run, s3_lr_probe
from gaussianhaircut_torch.utils.image import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_scene_matches_jax(tmp_path):
    j_tool = _jax_tool("pipeline_e2e_run")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    pipeline_e2e_run.build_scene(ours, 2, 64, 200, 16, device="cpu")
    j_tool.build_scene(theirs, 2, 64, 200, 16)
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(ours, "sparse", "0", name)) as a, \
                open(os.path.join(theirs, "sparse", "0", name)) as b:
            assert a.read() == b.read(), name
    pngs = sorted(os.path.relpath(os.path.join(d, f), ours)
                  for d, _, fs in os.walk(ours) for f in fs if f.endswith(".png"))
    assert len(pngs) == 8          # 2 views x (image + three masks)
    for rel in pngs:
        a = read_png(os.path.join(ours, rel)).astype(np.int32)
        b = read_png(os.path.join(theirs, rel)).astype(np.int32)
        assert a.shape == b.shape, rel
        diff = np.abs(a - b)
        assert (diff <= 1).mean() >= 0.999, (rel, diff.max(), (diff > 1).sum())
        assert a.any(), rel


def test_stage_parser_gives_the_jax_record_keys(tmp_path):
    log = ["[frames] 24 kept\n", "=== frames: done ===\n", "stage 1 it 100\n",
           "=== stage1: done ===\n", "=== render_gaussians: done ===\n", "tail\n"]
    ticks = iter([10.0, 11.5, 20.3, 20.3])
    with open(tmp_path / "run.log", "w") as f:
        times = pipeline_e2e_run.stage_seconds(log, clock=lambda: next(ticks), log=f)
    assert times == {"frames": 1.5, "stage1": 8.8, "render_gaussians": 0.0}
    assert (tmp_path / "run.log").read_text() == "".join(log)
    args = pipeline_e2e_run.parse_args([])
    rec = pipeline_e2e_run.record(args, 1, times, 6276.21, "runs/pipeline_run.log")
    with open(os.path.join(REPO, "PIPELINE_r05.json")) as f:
        want = json.load(f)
    assert set(rec) == set(want) and set(rec["config"]) == set(want["config"])
    assert rec["config"] == want["config"]
    assert (rec["total_seconds"], rec["total_hours"]) == (6276.2, 1.74)
    assert args.scene.startswith("runs") and args.out.startswith("runs")


TINY = ["--res", "32", "--views", "2", "--test_views", "1", "--num_strands", "16",
        "--teacher_strands", "16", "--strand_length", "8", "--pool_size", "200",
        "--texture_size", "16", "--device", "cpu"]


def _jax_probe_init(ckpt_path):
    """The JAX tool's computation of ``init`` (tools/s3_lr_probe.py:63-150)
    at TINY, through the JAX package's jnp renderer; writes the stage-2
    checkpoint it starts from."""
    qs = _jax_tool("quality_strands")
    res, n, length = 32, 16, 8
    rng = np.random.default_rng(0)
    pool = j_pool(200)
    radius_scale = jnp.asarray(6e-4, jnp.float32)
    scfg = JScfg(num_strands=n, texture_size=16, strand_length=length, sh_degree=1,
                 pool_size=200, use_diffusion=True)
    t_pts, t_rgb, _, _ = qs.teacher_strands(pool, n, length, rng)
    hair_t = qs.teacher_fields(t_pts, t_rgb, radius_scale, 1)
    head = j_stage2.make_head_fields(qs.make_head_model(rng))
    raster_cfg = JRasterConfig(backend="jnp", capacity_mult=5)
    bg = j_bg(False)
    cams = qs.make_cameras(3, res, res)

    @jax.jit
    def render(fields, colmap_t, fovx, fovy):
        cam = j_camera_geom(colmap_t, fovx, fovy, res, res, None)
        out = j_render(fields, 1, cam, bg, raster_cfg)
        return jnp.clip(out["render"], 0, 1), jnp.clip(out["mask"], 0, 1)[:1]

    c = cams[2]                            # the test view
    at_test = (jnp.asarray(c.colmap_transform), jnp.asarray(c.fovx), jnp.asarray(c.fovy))
    gt_img, gt_hair = render(j_stage2.concat_fields(head, hair_t), *at_test)

    # the stage-2 state, its decoder moved off its initial values
    hair = j_stage2.init_hair_state(dataclasses.replace(scfg, use_diffusion=False),
                                    jax.random.PRNGKey(0))
    noise = np.random.default_rng(5)
    hair = hair._replace(params=dict(hair.params, decoder=jax.tree.map(
        lambda x: x + 0.02 * noise.normal(size=x.shape).astype(np.float32),
        hair.params["decoder"])))
    j_stage2.save_checkpoint(hair, ckpt_path)
    key = jax.random.PRNGKey(1)
    params0, static0 = j_stage3.create_from_stage2(hair.params, pool, scfg, key, n)
    roots = np.asarray(jax.random.choice(key, 200, (n,), replace=False))
    img, hair_mask = render(j_stage2.concat_fields(head, j_stage3.curves_fields(
        params0, static0, scfg, radius_scale)), *at_test)
    psnr, l1 = float(JL.psnr(img, gt_img)), float(JL.l1_loss(hair_mask, gt_hair))
    chamfer = float(j_chamfer(j_stage3.curves_points(params0, static0).reshape(-1, 3),
                              t_pts.reshape(-1, 3)))
    return roots, {"test_psnr": round(psnr, 3), "hair_l1": round(l1, 5), "chamfer": chamfer}


def test_s3_lr_probe_init_matches_jax(tmp_path):
    ckpt = str(tmp_path / "hair.npz")
    roots, want = _jax_probe_init(ckpt)
    args = s3_lr_probe.parse_args(["--ckpt", ckpt] + TINY)
    probe = s3_lr_probe.build_probe(args, torch.device("cpu"))
    hair_params, params0, static0 = s3_lr_probe.initial_state(ckpt, probe,
                                                              torch.tensor(roots))
    psnr, l1 = s3_lr_probe.evaluate(probe, params0, static0, probe.test_cameras)
    with torch.no_grad():
        chamfer = probe.chamfer(s3_lr_probe.stage3.curves_points(params0, static0))
    assert abs(psnr - want["test_psnr"]) <= 2e-3, (psnr, want)
    assert abs(l1 - want["hair_l1"]) <= 2e-5, (l1, want)
    np.testing.assert_allclose(chamfer, want["chamfer"], rtol=1e-4)
    assert np.isfinite(psnr) and 0 < l1 < 1


def test_s3_lr_probe_main_writes_the_jax_keys(tmp_path):
    from gaussianhaircut_torch.models.textured_strands import TexturedStrandsConfig
    from gaussianhaircut_torch.train import stage2
    ckpt, out = str(tmp_path / "hair.npz"), str(tmp_path / "probe.json")
    scfg = TexturedStrandsConfig(num_strands=16, texture_size=16, strand_length=8, sh_degree=1,
                                 pool_size=200)
    stage2.save_checkpoint(stage2.init_hair_state(scfg, device="cpu"), ckpt)
    res = s3_lr_probe.main(["--ckpt", ckpt, "--iters", "2", "--lrs", "0.2", "--out", out]
                           + TINY)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert list(res) == ["init", "lr=0.2"]
    assert set(res["init"]) == {"test_psnr", "hair_l1", "chamfer"}
    assert set(res["lr=0.2"]) == {"test_psnr", "hair_l1", "chamfer", "l1_train_hist",
                                  "it_per_sec"}
    assert res["lr=0.2"]["l1_train_hist"] == []          # one entry every 20 iterations
    assert all(np.isfinite(v) for k, v in res["lr=0.2"].items() if k != "l1_train_hist")


def test_s3_lr_probe_refuses_a_checkpoint_of_another_sh_degree(tmp_path):
    """``--sh_degree`` must be the checkpoint's: a colour decoder of another
    width is an error, not a partial load."""
    from gaussianhaircut_torch.models.textured_strands import TexturedStrandsConfig
    from gaussianhaircut_torch.train import stage2
    ckpt = str(tmp_path / "hair.npz")
    stage2.save_checkpoint(stage2.init_hair_state(TexturedStrandsConfig(
        num_strands=16, texture_size=16, strand_length=8, sh_degree=1, pool_size=200),
        device="cpu"), ckpt)
    args = s3_lr_probe.parse_args(["--ckpt", ckpt, "--sh_degree", "3"] + TINY)
    probe = s3_lr_probe.build_probe(args, torch.device("cpu"))
    with pytest.raises(ValueError, match="expected"):
        s3_lr_probe.initial_state(ckpt, probe, torch.arange(16))
