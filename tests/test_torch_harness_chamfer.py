"""The strand harness's ``stage3_init_chamfer`` measured by both packages on
one JAX stage-2 checkpoint: the port's chamfers in its strand harness runs
were six times under the JAX record's, and this holds the measurement
itself.  The teacher strands (``teacher_strands`` of both harnesses, one
numpy seed, the same synthetic scalp pool), the stage-3 initial strands
(``create_from_stage2`` at JAX's root draws, the port loading the JAX
checkpoint) and the symmetric chamfer (the port's ``strand_chamfer``, the
JAX harness's ``chamfer_distance`` of the flattened points) agree within
rtol 1e-5."""
import dataclasses
import os
import sys

import jax
import numpy as np
import torch

from gaussianhaircut_tpu.models import textured_strands as jts
from gaussianhaircut_tpu.ops.chamfer import chamfer_distance as j_chamfer
from gaussianhaircut_tpu.train import stage2 as j_stage2
from gaussianhaircut_tpu.train import stage3 as j_stage3
from gaussianhaircut_torch.models import textured_strands as tts
from gaussianhaircut_torch.tools import quality_strands as t_qs
from gaussianhaircut_torch.train import stage2, stage3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import quality_strands as j_qs  # noqa: E402

TOL = dict(rtol=1e-5, atol=0)
# the harness's configuration (tools/quality_strands.py:288-294), cut
SCFG = dict(num_strands=48, texture_size=16, strand_length=12, sh_degree=1, pool_size=2000,
            use_diffusion=False)
TEACHER = 96


def test_stage3_init_chamfer_matches_jax(tmp_path):
    jscfg, scfg = jts.TexturedStrandsConfig(**SCFG), tts.TexturedStrandsConfig(**SCFG)
    jpool = jts.synthetic_scalp_pool(SCFG["pool_size"])
    tpool = tts.synthetic_scalp_pool(SCFG["pool_size"])
    j_teacher = j_qs.teacher_strands(jpool, TEACHER, SCFG["strand_length"],
                                     np.random.default_rng(0))[0]
    t_teacher = t_qs.teacher_strands(tpool, TEACHER, SCFG["strand_length"],
                                     np.random.default_rng(0), "cpu")[0]
    np.testing.assert_allclose(t_teacher.numpy(), np.asarray(j_teacher), **TOL)

    # a stage-2 state away from its initialisation, through its checkpoint
    rng = np.random.default_rng(1)
    hair = j_stage2.init_hair_state(jscfg, jax.random.PRNGKey(0))
    hair = hair._replace(params=dict(hair.params, decoder=jax.tree.map(
        lambda x: x + 0.02 * rng.normal(size=x.shape).astype(np.float32),
        hair.params["decoder"])))
    j_stage2.save_checkpoint(hair, str(tmp_path / "hair.npz"))
    template = stage2.init_hair_state(dataclasses.replace(scfg, use_diffusion=False),
                                      device="cpu")
    thair = stage2.load_checkpoint(str(tmp_path / "hair.npz"), template)

    # the JAX harness's roots (create_from_stage2 with PRNGKey(1))
    key = jax.random.PRNGKey(1)
    jparams, jstatic = j_stage3.create_from_stage2(hair.params, jpool, jscfg, key,
                                                   SCFG["num_strands"])
    roots = torch.tensor(np.asarray(jax.random.choice(
        key, SCFG["pool_size"], (SCFG["num_strands"],), replace=False)))
    tparams, tstatic = stage3.create_from_stage2(thair.params, tpool, scfg, roots)
    t_pts, j_pts = stage3.curves_points(tparams, tstatic), j_stage3.curves_points(jparams, jstatic)
    np.testing.assert_allclose(t_pts.numpy(), np.asarray(j_pts), rtol=1e-5, atol=1e-6)

    ours = t_qs.strand_chamfer(t_pts, t_teacher.reshape(-1, 3))
    ref = float(j_chamfer(j_pts.reshape(-1, 3), j_teacher.reshape(-1, 3)))
    assert ref > 0
    np.testing.assert_allclose(ours, ref, **TOL)
