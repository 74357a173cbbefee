"""Parity of the port's stage-2 step with the JAX package's on a toy scene
(16 strands of 8 points, a 16x16 texture, a 64-Gaussian head, one 48x48
view): one ``train_step`` from the JAX state carried across through its
checkpoint file, given the JAX step's own draws (roots, sigma, noise).
Cases: a self-trained denoiser with and without the EMA's texture pull, and
a frozen denoiser.  The UNet is cut to channels (32, 64) at depths (1, 1):
the JAX package builds its default UNet inside ``diffusion_loss``, so the
test swaps its ``DiffusionConfig`` for the cut one.

Tolerance: the stage-1 step's, rtol 1e-4 / atol 1e-6 (float32 renders and
networks summed in another order), on losses, parameters, moments and the
EMA after the step, from both packages' checkpoint files."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.config import OptimizationConfig as JOptConfig
from gaussianhaircut_tpu.models import diffusion as jd
from gaussianhaircut_tpu.models import gaussian_model as j_gm
from gaussianhaircut_tpu.models import textured_strands as jts
from gaussianhaircut_tpu.ops.rasterize import RasterConfig as JRasterConfig
from gaussianhaircut_tpu.scene.cameras import CameraBatch as JCameraBatch
from gaussianhaircut_tpu.scene.cameras import CameraStatic as JCameraStatic
from gaussianhaircut_tpu.train import stage2 as j_stage2
from gaussianhaircut_torch.config import OptimizationConfig
from gaussianhaircut_torch.models import diffusion as td
from gaussianhaircut_torch.models import gaussian_model as t_gm
from gaussianhaircut_torch.models import textured_strands as tts
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.scene.cameras import CameraBatch, CameraStatic
from gaussianhaircut_torch.train import optim as t_optim
from gaussianhaircut_torch.train import stage2

RES, POOL = 48, 400
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
SMALL_UNET = dict(mapping_out=64, depths=(1, 1), channels=(32, 64))
OPT = dict(lambda_dmask=0.1, lambda_dorient=0.1, lambda_dsds=0.5, diffusion_ema_warmup=5)
SCFG = dict(num_strands=16, texture_size=16, strand_length=8, sh_degree=1, pool_size=POOL,
            diffusion_input=8, scale_decoder=10.0, use_diffusion=True)
RADIUS = 5e-3


@pytest.fixture
def small_jax_unet(monkeypatch):
    monkeypatch.setattr(jd, "DiffusionConfig",
                        functools.partial(jd.DiffusionConfig, **SMALL_UNET))


def toy_scene():
    """Both packages' head, camera and ground truth from one seed: a head
    of 64 Gaussians whose first half is labelled head (label logit -2), one
    camera 2 units from the scalp cap, random ground truth."""
    rng = np.random.default_rng(0)
    pts = rng.normal(scale=0.2, size=(64, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (64, 3)).astype(np.float32)
    jhead_model = j_gm.create_from_pcd(pts, cols, 64, 1, 1.0)
    label = np.zeros((64, 1), np.float32)
    label[:32] = -2.0
    jhead_model = jhead_model.replace(params=jhead_model.params._replace(label=jnp.asarray(label)))
    thead_model = t_gm.create_from_pcd(pts, cols, 64, 1, 1.0, "cpu")
    thead_model.params.label.copy_(torch.tensor(label))
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.0
    cams = [cls(uid=0, colmap_id=0, image_name="0000", width=RES, height=RES,
                colmap_transform=w2c, fovx=0.8, fovy=0.8) for cls in (JCameraStatic, CameraStatic)]
    gt = dict(image=rng.uniform(size=(3, RES, RES)).astype(np.float32),
              mask=(rng.uniform(size=(2, RES, RES)) > 0.5).astype(np.float32),
              orient_angle=rng.uniform(size=(1, RES, RES)).astype(np.float32),
              orient_conf=rng.uniform(0.5, 1.5, size=(1, RES, RES)).astype(np.float32))
    return dict(jhead=j_stage2.make_head_fields(jhead_model),
                thead=stage2.make_head_fields(thead_model),
                jcams=JCameraBatch.from_cameras([cams[0]]),
                tcams=CameraBatch.from_cameras([cams[1]], "cpu"), gt=gt,
                jpool=jts.synthetic_scalp_pool(POOL, seed=1),
                tpool=tts.synthetic_scalp_pool(POOL, seed=1))


def perturb_state(jstate, rng, step: int):
    """Non-zero moments (so that Adam's first step is no sign function), a
    UNet whose zero-initialised last convolution carries gradient, and the
    step count."""
    noise = lambda x, s: x + s * rng.normal(size=x.shape).astype(np.float32)
    params = dict(jstate.params)
    if "denoiser" in params:
        params["denoiser"] = jax.tree.map(lambda x: noise(x, 0.03), params["denoiser"])
    mu = jax.tree.map(lambda x: noise(np.zeros_like(x), 1e-3), params)
    nu = jax.tree.map(lambda x: noise(np.zeros_like(x), 1e-3) ** 2 + 1e-8, params)
    ema = None if jstate.ema is None else jax.tree.map(lambda x: noise(x, 0.03), jstate.ema)
    return jstate._replace(params=params, opt=j_stage2.optim.AdamState(
        mu, nu, jnp.asarray(7, jnp.int32)), step=jnp.asarray(step, jnp.int32), ema=ema)


def port_template(scfg, den_cfg):
    """A port state of the toy's shapes to load a checkpoint into: the cut
    UNet (and its EMA) when the state trains a denoiser."""
    state = stage2.init_hair_state(dataclasses.replace(scfg, use_diffusion=False), device="cpu")
    if den_cfg is not None:
        state.params.denoiser = td.Denoiser(den_cfg)
        state.ema = td.Denoiser(den_cfg).requires_grad_(False)
        state.opt = t_optim.adam_init(dict(state.params.named_parameters()))
    return state


def jax_draws(jstate, scfg):
    """The draws the JAX step makes from its state's key
    (stage2.py:265, textured_strands.py:152, diffusion.py:138-143)."""
    _, k_strand, k_diff = jax.random.split(jstate.key, 3)
    roots = jax.random.choice(k_strand, POOL, (scfg.num_strands,), replace=False)
    k_noise, k_sigma = jax.random.split(k_diff)
    d, g = scfg.diffusion_input, scfg.geometry_descriptor_size
    sigma = jd.Denoiser(jd.DiffusionConfig(input_channels=g, input_size=d)).sample_density(
        k_sigma, (1,))
    noise = jax.random.normal(k_noise, (1, d, d, g))
    return stage2.Stage2Draws(*(torch.tensor(np.asarray(a)) for a in (roots, sigma, noise)))


def compare_files(port_path, jax_path, tol=STEP_TOL):
    with np.load(port_path) as a, np.load(jax_path) as b:
        got, ref = dict(a), dict(b)
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))
    for k in ref:
        if k == "key":
            continue
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)


@pytest.mark.parametrize("case", ["ema_pull", "before_warmup", "frozen_denoiser"])
def test_stage2_step_matches_jax(tmp_path, small_jax_unet, case):
    toy = toy_scene()
    jscfg = jts.TexturedStrandsConfig(**SCFG)
    scfg = tts.TexturedStrandsConfig(**SCFG)
    rng = np.random.default_rng(3)
    frozen = case == "frozen_denoiser"
    jstate = j_stage2.init_hair_state(jscfg, jax.random.PRNGKey(0), own_denoiser=not frozen)
    jstate = perturb_state(jstate, rng, 5 if case == "ema_pull" else 4)
    den_cfg = td.DiffusionConfig(input_channels=64, input_size=8, **SMALL_UNET)
    jden = tden = None
    if frozen:
        jden = jax.tree.map(lambda x: x + 0.03 * rng.normal(size=x.shape).astype(np.float32),
                            jd.Denoiser(jd.DiffusionConfig(input_channels=64, input_size=8))
                            .init(jax.random.PRNGKey(4)))
        from gaussianhaircut_tpu.models import prior_io as j_prior_io
        j_prior_io.save_prior(str(tmp_path / "prior.npz"), {"denoiser": jden})
        from gaussianhaircut_torch.models import prior_io
        tden = prior_io.load_prior(str(tmp_path / "prior.npz"), diffusion_input=8)["denoiser"]
        assert tden.cfg.channels == (32, 64)
    j_stage2.save_checkpoint(jstate, str(tmp_path / "j0.npz"))
    tstate = stage2.load_checkpoint(str(tmp_path / "j0.npz"),
                                    port_template(scfg, None if frozen else den_cfg))
    assert tstate.step == int(jstate.step)

    gt = toy["gt"]
    jopt, topt = JOptConfig(**OPT), OptimizationConfig(**OPT)
    j_new, j_metrics = j_stage2.train_step(
        jstate, toy["jhead"], toy["jpool"], toy["jcams"], gt["image"], gt["mask"],
        gt["orient_angle"], gt["orient_conf"], jnp.asarray(0), None, jnp.asarray(RADIUS),
        jden, None, scfg=jscfg, width=RES, height=RES,
        raster_cfg=JRasterConfig(tile_w=16, tile_h=16, chunk=32, capacity_mult=64,
                                 backend="jnp"),
        opt_cfg=jopt, white_background=False, total_iters=50)
    t_new, t_metrics = stage2.train_step(
        tstate, toy["thead"], toy["tpool"], toy["tcams"],
        *(torch.tensor(gt[k]) for k in ("image", "mask", "orient_angle", "orient_conf")),
        0, None, torch.tensor(RADIUS), tden, None, scfg=scfg, width=RES, height=RES,
        raster_cfg=RasterConfig(16, 16, 32), opt_cfg=topt, white_background=False,
        total_iters=50, draws=jax_draws(jstate, jscfg))

    assert t_metrics["num_rendered_3sigma"] >= t_metrics["num_rendered"] > 0
    assert t_metrics["opt_tail_leaves"] == 0      # the CPU runs the per-leaf composition
    assert t_metrics["precompute_gaussians"] == 0  # and the precompute's composition
    for k in ("l1", "mask", "orient", "sds", "total", "grad_norm"):
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), err_msg=k,
                                   **STEP_TOL)
    assert float(t_metrics["sds"]) > 0
    j_stage2.save_checkpoint(j_new, str(tmp_path / "j1.npz"))
    stage2.save_checkpoint(t_new, str(tmp_path / "t1.npz"))
    compare_files(str(tmp_path / "t1.npz"), str(tmp_path / "j1.npz"))
