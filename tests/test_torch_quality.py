"""The quality harnesses of the port (``gaussianhaircut_torch/tools/
quality_run.py`` and ``quality_strands.py``) against the JAX tools
(``tools/quality_run.py``, ``tools/quality_strands.py``) at a tiny size:

- the cameras (equal), the teachers (equal draws from one numpy seed; the
  strand teacher within float32 of the JAX one, its GaussianFields within
  rtol 1e-5) and the ground-truth renders through the JAX package's plain
  rasterizer and the port's plain compositing, at the forward tolerance of
  tests/test_rasterize.py:166 (rtol 5e-4, atol 5e-3);
- one run of each port harness for a few iterations on the CPU, which
  prints a JSON record with the JAX records' keys (``QUALITY_r05.json``,
  ``QUALITY_STRANDS_r04.json``)."""
import functools
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

from gaussianhaircut_tpu.models import gaussian_model as j_gm
from gaussianhaircut_tpu.models import textured_strands as jts
from gaussianhaircut_tpu.ops.rasterize import RasterConfig as JRasterConfig
from gaussianhaircut_tpu.render import renderer as j_renderer
from gaussianhaircut_tpu.scene.cameras import camera_geom as j_camera_geom
from gaussianhaircut_tpu.train import stage2 as j_stage2
from gaussianhaircut_torch.models import diffusion as td
from gaussianhaircut_torch.models import textured_strands as tts
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.tools import quality_run as t_qr
from gaussianhaircut_torch.tools import quality_strands as t_qs
from gaussianhaircut_torch.train import prior as t_prior
from gaussianhaircut_torch.train import stage2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import quality_run as j_qr  # noqa: E402
import quality_strands as j_qs  # noqa: E402

FWD_TOL = dict(rtol=5e-4, atol=5e-3)
RES = 48


def _jax_gt(render_fn, cam, res):
    geom = j_camera_geom(jnp.asarray(cam.colmap_transform), jnp.asarray(cam.fovx),
                         jnp.asarray(cam.fovy), res, res, None)
    out = render_fn(geom)
    return [np.clip(np.asarray(out[k]), 0, 1) for k in ("render", "mask", "orient_angle")]


def _same_cameras(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.colmap_transform, b.colmap_transform)
        assert (a.fovx, a.fovy, a.width, a.height, a.image_name) == (
            b.fovx, b.fovy, b.width, b.height, b.image_name)


def test_stage1_teacher_cameras_and_gt_match_jax():
    p = 300
    _same_cameras(t_qr.make_cameras(5, RES, RES), j_qr.make_cameras(5, RES, RES))
    # the JAX tool's draws (tools/quality_run.py:80-84, :119-121)
    rng = np.random.default_rng(0)
    pts = rng.normal(scale=0.3, size=(p, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(p, 3)).astype(np.float32)
    init = pts + rng.normal(scale=0.02, size=pts.shape).astype(np.float32)
    got = t_qr.teacher_and_student_init(p)
    for a, b in zip(got, (pts, cols, init, np.full_like(cols, 0.5))):
        np.testing.assert_array_equal(a, b)
    jteacher = j_gm.create_from_pcd(pts, cols, p, 3, 1.0)
    teacher = t_qr.gm.create_from_pcd(pts, cols, p, 3, 1.0, "cpu")
    jcfg = JRasterConfig(backend="jnp", capacity_mult=10)
    bg = j_renderer.default_background(False)
    for cam in t_qr.make_cameras(3, RES, RES):
        ref = _jax_gt(lambda g: j_renderer.render(jteacher.params, jteacher.aux.alive, 3, g,
                                                  bg, jcfg), cam, RES)
        out = [t.numpy() for t in t_qr.render_gt(teacher, cam, RasterConfig())]
        for name, a, b in zip(("image", "mask", "angle"), out, ref):
            np.testing.assert_allclose(a, b, err_msg=name, **FWD_TOL)
        assert ref[0].std() > 0.05


def test_strand_teacher_cameras_and_gt_match_jax():
    n, length, pool_size = 64, 8, 800
    _same_cameras(t_qs.make_cameras(4, RES, RES), j_qs.make_cameras(4, RES, RES))
    jpool = jts.synthetic_scalp_pool(pool_size)
    pool = tts.synthetic_scalp_pool(pool_size)
    jrng, rng = np.random.default_rng(0), np.random.default_rng(0)
    jt = j_qs.teacher_strands(jpool, n, length, jrng)
    t = t_qs.teacher_strands(pool, n, length, rng, "cpu")
    for name, a, b in zip(("points", "rgb", "uvs", "l2w"), t, jt):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    radius = 2e-3
    jhair = j_qs.teacher_fields(jt[0], jt[1], jnp.asarray(radius, jnp.float32), 1)
    hair = t_qs.teacher_fields(torch.tensor(np.asarray(jt[0])), torch.tensor(np.asarray(jt[1])),
                               torch.tensor(radius), 1)
    for f in ("xyz", "features", "scaling", "rotation_matrix", "opacity", "orient_conf"):
        np.testing.assert_allclose(getattr(hair, f).numpy(), np.asarray(getattr(jhair, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    jhead_model = j_qs.make_head_model(jrng, capacity=256, n=128)
    head_model = t_qs.make_head_model(rng, capacity=256, n=128, device="cpu")
    np.testing.assert_array_equal(head_model.params.xyz.numpy(),
                                  np.asarray(jhead_model.params.xyz))
    jfields = j_stage2.concat_fields(j_stage2.make_head_fields(jhead_model), jhair)
    fields = stage2.concat_fields(stage2.make_head_fields(head_model), hair)
    jcfg = JRasterConfig(backend="jnp", capacity_mult=24)
    bg = j_renderer.default_background(False)
    cams = t_qs.make_cameras(3, RES, RES)
    t_qs.attach_gt(cams, fields, 1, RasterConfig(tile_w=16, tile_h=16, chunk=64))
    for cam in cams:
        ref = _jax_gt(lambda g: j_renderer.render_fields(jfields, 1, g, bg, jcfg), cam, RES)
        for name, a, b in zip(("image", "mask", "angle"), (cam.image, cam.mask,
                                                           cam.orient_angle), ref):
            np.testing.assert_allclose(a, b, err_msg=name, **FWD_TOL)
        assert cam.mask_hair.max() > 0.5                   # the strands show


def _record(name):
    with open(os.path.join(REPO, name)) as f:
        rec = json.load(f)
    return rec


def test_quality_run_prints_the_jax_record(capsys, tmp_path):
    out = tmp_path / "q.json"
    res = t_qr.main(["--iters", "4", "--teacher_p", "150", "--res", "32", "--views", "2",
                     "--test_views", "1", "--eval_every", "2", "--device", "cpu",
                     "--out", str(out)])
    rec = _record("QUALITY_r05.json")
    assert set(res) == set(rec) and set(res["config"]) == set(rec["config"])
    assert set(res["heldout_curve"][0]) == set(rec["heldout_curve"][0])
    assert [c["iter"] for c in res["heldout_curve"]] == [2, 4]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert json.loads(out.read_text()) == res
    assert np.isfinite(res["test_psnr"]) and res["num_alive"] == 150


def test_quality_strands_prints_the_jax_record(monkeypatch):
    """Stage 2 without the diffusion prior, stage 3 with SDS from a prior
    distilled for two steps (its UNet cut to channels 32, 64)."""
    monkeypatch.setattr(t_prior, "DiffusionConfig", functools.partial(
        td.DiffusionConfig, mapping_out=64, depths=(1, 1), channels=(32, 64)))
    res = t_qs.main(["--iters2", "2", "--iters3", "2", "--res", "32", "--views", "2",
                     "--test_views", "1", "--teacher_strands", "24", "--num_strands", "12",
                     "--strand_length", "6", "--pool_size", "300", "--texture_size", "32",
                     "--use_sds_stage3", "--prior_steps", "2", "--device", "cpu"])
    rec = _record("QUALITY_STRANDS_r04.json")
    # the record was written by --rate_probe after the run; the tool now
    # always says whether stage 2 was warm-started
    assert set(res) == set(rec) - {"stage2_rate_source"} | {"warm_start"}
    assert set(res["config"]) == set(rec["config"])
    assert res["stage3_prior_steps"] == 2 and np.isfinite(res["stage3_chamfer"])
