"""Parity of the port's stage-3 step with the JAX package's on the stage-2
toy scene (``tests/test_torch_stage2.py``): ``create_from_stage2`` at the
JAX package's roots, then one ``train_step`` from the JAX curves state
carried across through its checkpoint file, with and without the SDS term
(given the JAX step's guiding strands, noise and sigma), and the NaN-guard
step (a NaN in the ground truth: both skip the update and keep the
moments).  The SDS prior is a small one (strands of 8, the cut UNet) written
by the JAX package and read by the port.

Tolerance: the stage-1 step's, rtol 1e-4 / atol 1e-6, on losses,
parameters and moments after the step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.config import OptimizationConfig as JOptConfig
from gaussianhaircut_tpu.models import diffusion as jd
from gaussianhaircut_tpu.models import prior_io as j_prior_io
from gaussianhaircut_tpu.models import strand_prior as jsp
from gaussianhaircut_tpu.models import textured_strands as jts
from gaussianhaircut_tpu.ops.rasterize import RasterConfig as JRasterConfig
from gaussianhaircut_tpu.train import stage2 as j_stage2
from gaussianhaircut_tpu.train import stage3 as j_stage3
from gaussianhaircut_torch.config import OptimizationConfig
from gaussianhaircut_torch.models import prior_io
from gaussianhaircut_torch.models import textured_strands as tts
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.train import stage2, stage3
from tests.test_torch_stage2 import (  # noqa: F401  (small_jax_unet: a fixture)
    RADIUS, RES, SCFG, STEP_TOL, compare_files, port_template, small_jax_unet, toy_scene,
)

OPT = dict(lambda_dmask=0.1, lambda_dorient=0.1, lambda_dsds=0.5)
N = 16


def _jax_prior(rng):
    noisy = lambda t: jax.tree.map(
        lambda x: x + 0.03 * rng.normal(size=x.shape).astype(np.float32), t)
    return {"encoder": noisy(jsp.StrandEncoder().init(jax.random.PRNGKey(5),
                                                      jnp.zeros((1, SCFG["strand_length"], 3)))),
            "denoiser": noisy(jd.Denoiser(jd.DiffusionConfig(input_channels=64, input_size=8))
                              .init(jax.random.PRNGKey(6)))}


def _curves(tmp_path, rng):
    """A JAX curves state from a stage-2 state, with non-zero moments, and
    the port's from the same stage-2 checkpoint at the same roots."""
    jscfg = jts.TexturedStrandsConfig(**dict(SCFG, use_diffusion=False))
    scfg = tts.TexturedStrandsConfig(**dict(SCFG, use_diffusion=False))
    hair = j_stage2.init_hair_state(jscfg, jax.random.PRNGKey(0))
    hair = hair._replace(params=dict(hair.params, decoder=jax.tree.map(
        lambda x: x + 0.02 * rng.normal(size=x.shape).astype(np.float32),
        hair.params["decoder"])))
    j_stage2.save_checkpoint(hair, str(tmp_path / "hair.npz"))
    toy = toy_scene()
    key = jax.random.PRNGKey(2)
    jparams, jstatic = j_stage3.create_from_stage2(hair.params, toy["jpool"], jscfg, key, N)
    roots = torch.tensor(np.asarray(jax.random.choice(key, SCFG["pool_size"], (N,),
                                                      replace=False)))
    thair = stage2.load_checkpoint(str(tmp_path / "hair.npz"), port_template(scfg, None))
    tparams, tstatic = stage3.create_from_stage2(thair.params, toy["tpool"], scfg, roots)
    for rec_t, rec_j in ((tparams, jparams), (tstatic, jstatic)):
        for name, v in zip(rec_t.names(), rec_t.values()):
            np.testing.assert_allclose(v.numpy(), np.asarray(getattr(rec_j, name)),
                                       err_msg=name, **STEP_TOL)
    noise = lambda x, s: s * rng.normal(size=x.shape).astype(np.float32)
    jstate = j_stage3.CurvesTrainState(
        jparams, jstatic, j_stage3.optim.AdamState(
            jax.tree.map(lambda x: noise(x, 1e-3), jparams),
            jax.tree.map(lambda x: noise(x, 1e-3) ** 2 + 1e-8, jparams),
            jnp.asarray(7, jnp.int32)), jnp.asarray(3, jnp.int32))
    j_stage3.save_checkpoint(jstate, str(tmp_path / "c0.npz"))
    return toy, jscfg, scfg, jstate, stage3.load_checkpoint(str(tmp_path / "c0.npz"), "cpu")


@pytest.mark.parametrize("case", ["image_only", "sds", "nan_guard"])
def test_stage3_step_matches_jax(tmp_path, small_jax_unet, case):
    rng = np.random.default_rng(11)
    toy, jscfg, scfg, jstate, tstate = _curves(tmp_path, rng)
    use_sds = case == "sds"
    jprior = tprior = draws = sds_key = None
    if use_sds:
        jprior = _jax_prior(rng)
        j_prior_io.save_prior(str(tmp_path / "prior.npz"), jprior)
        tprior = prior_io.load_strand_prior(str(tmp_path / "prior.npz"),
                                            strand_length=SCFG["strand_length"],
                                            diffusion_input=8)
        sds_key = jax.random.PRNGKey(9)
        # the JAX SDS draws (stage3.py sds_loss): guides, noise, sigma
        k_idx, k_noise, k_sigma = jax.random.split(sds_key, 3)
        draws = stage3.Stage3Draws(*(torch.tensor(np.asarray(a)) for a in (
            jax.random.randint(k_idx, (N,), 0, N),
            jax.random.normal(k_noise, (1, 8, 8, 64)),
            jd.Denoiser(jd.DiffusionConfig(input_channels=64, input_size=8)).sample_density(
                k_sigma, (1,)))))
    gt = dict(toy["gt"])
    if case == "nan_guard":
        gt["image"] = gt["image"].copy()
        gt["image"][0, 5, 7] = np.nan
    jopt, topt = JOptConfig(**OPT), OptimizationConfig(**OPT)
    j_new, j_metrics = j_stage3.train_step(
        jstate, toy["jhead"], toy["jcams"], gt["image"], gt["mask"], gt["orient_angle"],
        gt["orient_conf"], jnp.asarray(0), None, jnp.asarray(RADIUS), jprior, sds_key,
        scfg=jscfg, width=RES, height=RES,
        raster_cfg=JRasterConfig(tile_w=16, tile_h=16, chunk=32, capacity_mult=64,
                                 backend="jnp"),
        opt_cfg=jopt, white_background=False, spatial_lr_scale=0.3, use_sds=use_sds)
    t_new, t_metrics = stage3.train_step(
        tstate, toy["thead"], toy["tcams"],
        *(torch.tensor(gt[k]) for k in ("image", "mask", "orient_angle", "orient_conf")),
        0, None, torch.tensor(RADIUS), tprior, draws, scfg=scfg, width=RES, height=RES,
        raster_cfg=RasterConfig(16, 16, 32), opt_cfg=topt, white_background=False,
        spatial_lr_scale=0.3, use_sds=use_sds)

    assert t_metrics["num_rendered"] > 0 and t_new.step == 4
    assert float(t_metrics["grads_finite"]) == float(j_metrics["grads_finite"]) == float(
        case != "nan_guard")
    keys = ["l1", "ssim", "mask", "orient", "sds", "total"]
    if case != "nan_guard":
        keys.append("grad_norm")
    if use_sds:
        keys.append("sds_gscale")
        assert float(t_metrics["sds"]) > 0
    for k in keys:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), err_msg=k,
                                   equal_nan=True, **STEP_TOL)
    j_stage3.save_checkpoint(j_new, str(tmp_path / "j1.npz"))
    stage3.save_checkpoint(t_new, str(tmp_path / "t1.npz"))
    compare_files(str(tmp_path / "t1.npz"), str(tmp_path / "j1.npz"))
    if case == "nan_guard":
        # a skipped step: parameters and moments as they were, count kept
        with np.load(str(tmp_path / "t1.npz")) as a, np.load(str(tmp_path / "c0.npz")) as b:
            for k in b.files:
                if k != "step":
                    assert np.array_equal(a[k], b[k]), k
    np.testing.assert_allclose(stage3.export_points(t_new), j_stage3.export_points(j_new),
                               **STEP_TOL)
