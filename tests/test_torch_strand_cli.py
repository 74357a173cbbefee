"""The strand CLIs end to end on the CPU, across packages, on a tiny
on-disk scene (150 points, two 64x48 views) and the port's stage 1:

- the port's ``train_latent_strands`` and the JAX package's, on the port's
  stage-1 model, write checkpoints of the same keys and shapes;
- the JAX ``train_strands`` starts from the port's stage-2 checkpoint, and
  the port's from the JAX package's, with an SDS prior written by the JAX
  package;
- the port's ``export_curves`` writes what the JAX package's
  ``stage3.export_points`` reads from the same checkpoint, for a checkpoint
  of either package.

16 strands of 8 points, a 16x16 texture, 2 iterations per stage.  The
exported points: rtol 1e-6 / atol 1e-7 (one float32 cumsum each)."""
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussianhaircut_tpu.cli import train_latent_strands as j_s2
from gaussianhaircut_tpu.cli import train_strands as j_s3
from gaussianhaircut_tpu.models import diffusion as jd
from gaussianhaircut_tpu.models import prior_io as j_prior_io
from gaussianhaircut_tpu.models import strand_prior as jsp
from gaussianhaircut_tpu.scene import ply as j_ply
from gaussianhaircut_tpu.train import stage3 as j_stage3
from gaussianhaircut_torch.cli import export_curves, train_gaussians, train_latent_strands
from gaussianhaircut_torch.cli import train_strands
from gaussianhaircut_torch.scene.synthetic import bench_scene, write_colmap_scene
from gaussianhaircut_torch.train import stage3

ITERS = 2
STRAND = ["--num_strands", "16", "--strand_length", "8", "--texture_size", "16",
          "--diffusion_input", "8", "--sh_degree", "1", "--iterations", str(ITERS),
          "--checkpoint_iterations", str(ITERS), "--lambda_dmask", "0.1",
          "--lambda_dorient", "0.1", "--lambda_dsds", "0.01"]
EXPORT_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("strand_cli"))
    p = {k: os.path.join(root, k) for k in ("scene", "model", "hair_t", "hair_j")}
    p.update({k: os.path.join(root, "curves_reconstruction", k) for k in ("c_t", "c_j")})
    write_colmap_scene(bench_scene(150, 64, 48, 2, seed=11), p["scene"])
    train_gaussians.main(["-s", p["scene"], "-m", p["model"], "--device", "cpu",
                          "--sh_degree", "1", "--gaussian_capacity", "256",
                          "--iterations", "3", "--test_iterations", "3",
                          "--save_iterations", "3", "--checkpoint_iterations", "3"])
    rng = np.random.default_rng(0)
    noisy = lambda t: jax.tree.map(
        lambda x: x + 0.03 * rng.normal(size=x.shape).astype(np.float32), t)
    j_prior_io.save_prior(os.path.join(root, "prior.npz"), {
        "encoder": noisy(jsp.StrandEncoder().init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)))),
        "denoiser": noisy(jd.Denoiser(jd.DiffusionConfig(
            input_channels=64, input_size=8, mapping_out=32, depths=(1, 1),
            channels=(32, 64))).init(jax.random.PRNGKey(1)))})
    common = ["-s", p["scene"], "-m", p["model"]] + STRAND
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        train_latent_strands.main(common + ["--model_path_hair", p["hair_t"], "--device", "cpu"])
        j_s2.main(common + ["--model_path_hair", p["hair_j"], "--raster_backend", "jnp"])
        ck = lambda d: os.path.join(d, "checkpoints", f"{ITERS}.npz")
        # each package's stage 3 from the other's stage-2 checkpoint
        j_s3.main(common + ["--model_path_hair", p["hair_t"], "--model_path_curves", p["c_j"],
                            "--start_checkpoint_hair", ck(p["hair_t"]),
                            "--raster_backend", "jnp"])
        state = train_strands.main(common + [
            "--model_path_hair", p["hair_j"], "--model_path_curves", p["c_t"],
            "--start_checkpoint_hair", ck(p["hair_j"]), "--use_sds",
            "--prior_checkpoint", os.path.join(root, "prior.npz"), "--device", "cpu"])
    finally:
        mp.undo()
    return dict(root=root, state=state, ck=ck, **p)


def test_stage2_checkpoints_share_a_layout(runs):
    """The two packages' stage-2 checkpoints of one configuration hold the
    same keys, shapes and dtypes (a uint32[2] key among them), and the
    port's values are finite."""
    with np.load(runs["ck"](runs["hair_t"])) as a, np.load(runs["ck"](runs["hair_j"])) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        assert a["key"].dtype == np.uint32 and a["key"].shape == (2,)
        assert int(a["step"]) == ITERS
        assert all(np.isfinite(a[k]).all() for k in a.files)


def test_stage3_across_packages(runs):
    """Stage 3 ran in each package from the other's stage-2 checkpoint;
    the port's run took the JAX package's prior, its SDS term included."""
    assert runs["state"].step == ITERS
    for d in ("c_t", "c_j"):
        assert os.path.exists(runs["ck"](runs[d])), d
    assert np.isfinite(stage3.export_points(runs["state"])).all()


@pytest.mark.parametrize("which", ["c_t", "c_j"])
def test_export_curves_matches_jax(runs, which):
    """The port's export of a stage-3 checkpoint (either package's): the
    pickle and the PLY hold the JAX package's export_points."""
    pts = export_curves.main(["--data_dir", runs["root"], "--model_name", which,
                              "--iter", str(ITERS), "--device", "cpu"])
    ref = j_stage3.export_points(j_stage3.load_checkpoint(runs["ck"](runs[which])))
    assert pts.shape == ref.shape == (16, 8, 3)
    out = os.path.join(runs[which], "strands")
    with open(os.path.join(out, f"{ITERS}_strands.pkl"), "rb") as f:
        pkl = pickle.load(f)
    np.testing.assert_allclose(pkl, ref, **EXPORT_TOL)
    v = j_ply.read_ply(os.path.join(out, f"{ITERS}_strands.ply"))["vertex"]
    xyz = np.stack([v[n] for n in ("x", "y", "z")], -1)
    np.testing.assert_allclose(xyz, ref.reshape(-1, 3), **EXPORT_TOL)
    assert np.array_equal(stage3.export_points(stage3.load_checkpoint(
        runs["ck"](runs[which]), "cpu")), pts)
