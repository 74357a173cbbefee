"""The port's three pretrained-weight converters against the JAX package's
(``tools/convert_{lpips,neuralhaircut_ckpt,hyperiqa}.py``, loaded by path):
each npz a port converter writes loads in the JAX consumer and in the
port's with the same outputs, and the reverse.

- LPIPS: torchvision- and LPIPS-layout files fabricated from
  ``synthesize_weights(0)`` convert back to it bit for bit; the fixture
  distances of the two packages agree within rtol 1e-5; each package's
  ``verify`` accepts the other's npz; the port's selftest meets the
  constants recorded in the JAX tool (rtol 3e-3).
- NeuralHaircut: ``main`` on the upstream twin of
  ``tests/test_prior_convert_e2e.py`` (and a twin denoiser, the student's
  UNet cut to channels (32, 64)); the npz loads in both ``load_prior`` and
  ``warm_start``, and both decoders give the same segments (rtol 1e-5);
  the selftest's held-out relative MSE is under 0.08.
- hyperIQA: ``distill`` fits the Laplacian-variance teacher (held-out
  Spearman > 0.8 and the sharpest above the blurriest, as
  ``tests/test_iqa_converter.py`` asks); both ``CnnScorer``s score an npz
  alike (rtol 1e-5); ``gaussian_blur_like_cv2`` equals ``cv2.GaussianBlur``
  within 1e-6; ``main`` runs on a fabricated hyperIQA twin over PNG frames.
"""
import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.models import prior_io as j_prior_io
from gaussianhaircut_tpu.models import strand_prior as j_sp
from gaussianhaircut_tpu.models.textured_strands import TexturedStrandsConfig as JScfg
from gaussianhaircut_tpu.preprocessing import iqa as j_iqa
from gaussianhaircut_tpu.train import stage2 as j_stage2
from gaussianhaircut_torch.models import prior_io
from gaussianhaircut_torch.models.textured_strands import TexturedStrandsConfig
from gaussianhaircut_torch.ops.lpips import _VGG_CONV_INDICES, synthesize_weights
from gaussianhaircut_torch.preprocessing import iqa
from gaussianhaircut_torch.tools import convert_hyperiqa as t_hiqa
from gaussianhaircut_torch.tools import convert_lpips as t_lpips
from gaussianhaircut_torch.tools import convert_neuralhaircut_ckpt as t_nh
from gaussianhaircut_torch.train import stage2
from tests.upstream_twins import (
    VGG_CONV_INDICES, write_hyperiqa_tree, write_lpips_files, write_neuralhaircut_tree,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-7)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def upstream_imports():
    """Drops what an upstream tree put on sys.path and in sys.modules."""
    path, mods = list(sys.path), set(sys.modules)
    yield
    sys.path[:] = path
    for name in set(sys.modules) - mods:
        if name.split(".")[0] in ("src", "models"):
            del sys.modules[name]


# ---------------------------------------------------------------- LPIPS

def test_lpips_convert_roundtrips_and_crosses_verify(tmp_path):
    blob = synthesize_weights(0)
    assert VGG_CONV_INDICES == _VGG_CONV_INDICES
    vgg, lin = write_lpips_files(str(tmp_path), blob)
    # the file name embeds its digest's prefix, as torchvision's does
    named = tmp_path / f"vgg16-{t_lpips._sha256(vgg)[:8]}.pth"
    os.rename(vgg, named)
    out = str(tmp_path / "lpips_vgg.npz")
    got = t_lpips.convert(str(named), lin, out, device="cpu")
    for k, v in blob.items():
        if k != "kind":
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert str(got["kind"]) == "pretrained"
    assert str(got["source_sha256_vgg16"]).startswith(named.name[6:14])

    j_tool = _jax_tool("convert_lpips")
    with np.load(out) as z:
        d = dict(z)
    np.testing.assert_allclose(j_tool._eval_fixtures(d), t_lpips._eval_fixtures(d, "cpu"),
                               **TOL)
    assert j_tool.verify(out) == 0          # the JAX package accepts the port's npz
    assert t_lpips.verify(out, "cpu") == 0
    # and the port accepts one the JAX package wrote
    jblob = synthesize_weights(1)
    _, d_ab, d_ac = j_tool._eval_fixtures(jblob)
    jblob.update(fixture_d_ab=np.asarray(d_ab), fixture_d_ac=np.asarray(d_ac))
    np.savez(tmp_path / "jax.npz", **jblob)
    assert t_lpips.verify(str(tmp_path / "jax.npz"), "cpu") == 0
    # a file whose name does not carry its digest's prefix is refused
    bad = tmp_path / "vgg16-00000000.pth"
    os.rename(named, bad)
    with pytest.raises(ValueError, match="does not match"):
        t_lpips.convert(str(bad), lin, out, device="cpu")


def test_lpips_selftest_meets_recorded_constants():
    _, d_ab, d_ac = t_lpips._eval_fixtures(synthesize_weights(), "cpu")
    np.testing.assert_allclose([d_ab, d_ac], [t_lpips._FIX_D_AB, t_lpips._FIX_D_AC], rtol=3e-3)
    j_tool = _jax_tool("convert_lpips")
    assert (t_lpips._FIX_SEED, t_lpips._FIX_D_AB, t_lpips._FIX_D_AC) == (
        j_tool._FIX_SEED, j_tool._FIX_D_AB, j_tool._FIX_D_AC)
    assert t_lpips.main(["--selftest", "--device", "cpu"]) == 0


# --------------------------------------------------------- NeuralHaircut

def test_neuralhaircut_main_loads_in_both_packages(tmp_path, monkeypatch, upstream_imports):
    nh, ckpt, den = write_neuralhaircut_tree(str(tmp_path))
    monkeypatch.setattr(t_nh, "DiffusionConfig", functools.partial(
        t_nh.DiffusionConfig, channels=(32, 64), depths=(1, 1)))
    out = str(tmp_path / "strand_prior.npz")
    assert t_nh.main(["--neuralhaircut_dir", nh, "--strand_ckpt", ckpt, "--diffusion_ckpt", den,
                      "--out", out, "--steps", "30", "--batch", "64", "--device", "cpu"]) == 0

    jprior = j_prior_io.load_prior(out)
    assert set(jprior) == {"encoder", "decoder", "denoiser"}
    jstate = j_stage2.init_hair_state(JScfg(num_strands=32, texture_size=16, strand_length=100,
                                            sh_degree=1), jax.random.PRNGKey(0))
    jwarm = j_stage2.warm_start(jstate, jprior)
    tprior = prior_io.load_prior(out, strand_length=100)
    assert set(tprior) == {"encoder", "decoder", "denoiser"}
    assert all(torch.isfinite(p).all() for m in tprior.values() for p in m.parameters())
    tstate = stage2.init_hair_state(TexturedStrandsConfig(num_strands=32, texture_size=16,
                                                          strand_length=100, sh_degree=1),
                                    device="cpu")
    twarm = stage2.warm_start(tstate, tprior)

    z = np.random.default_rng(7).normal(size=(5, j_sp.GEOMETRY_DIM)).astype(np.float32)
    want = np.asarray(j_sp.StrandDecoder(length=100).apply(jwarm.params["decoder"], z))
    with torch.no_grad():
        got = twarm.params.decoder(torch.from_numpy(z)).numpy()
        got_prior = tprior["decoder"](torch.from_numpy(z)).numpy()
    assert want.shape == (5, 99, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, got_prior)
    pts = np.random.default_rng(8).normal(size=(3, 100, 3)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            tprior["encoder"](torch.from_numpy(pts)).numpy(),
            np.asarray(j_sp.StrandEncoder().apply(jprior["encoder"], pts)), rtol=1e-5, atol=1e-6)


def test_neuralhaircut_jax_prior_loads_in_the_port(tmp_path):
    """The reverse: a prior the JAX package writes decodes alike in the port."""
    dec = j_sp.StrandDecoder(length=100).init(jax.random.PRNGKey(4),
                                              jnp.zeros((1, j_sp.GEOMETRY_DIM)))
    j_prior_io.save_prior(str(tmp_path / "jax_prior.npz"), {"decoder": dec})
    tprior = prior_io.load_prior(str(tmp_path / "jax_prior.npz"), strand_length=100)
    tstate = stage2.warm_start(stage2.init_hair_state(
        TexturedStrandsConfig(num_strands=8, texture_size=16, strand_length=100, sh_degree=1),
        device="cpu"), tprior)
    z = np.random.default_rng(9).normal(size=(4, j_sp.GEOMETRY_DIM)).astype(np.float32)
    with torch.no_grad():
        got = tstate.params.decoder(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_sp.StrandDecoder(length=100).apply(dec, z)),
                               rtol=1e-5, atol=1e-6)


def test_neuralhaircut_selftest_fits():
    assert t_nh.selftest("cpu") == 0


# --------------------------------------------------------------- hyperIQA

@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_gaussian_blur_like_cv2(k):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(k)
    for shape in ((37, 41, 3), (30, 23)):
        x = rng.uniform(size=shape).astype(np.float32)
        np.testing.assert_allclose(t_hiqa.gaussian_blur_like_cv2(x, k),
                                   cv2.GaussianBlur(x, (k, k), 0), rtol=0, atol=1e-6)
    # the selftest corpus's explicit sigmas (k = 2 int(3 sigma) + 1)
    s = {3: 0.7, 5: 1.4, 7: 2.2, 9: 3.0}[k]
    kk = 2 * int(3 * s) + 1
    np.testing.assert_allclose(t_hiqa.gaussian_blur_like_cv2(x, kk, s),
                               cv2.GaussianBlur(x, (kk, kk), s), rtol=0, atol=1e-6)


def _both_scores(path, x):
    ref = j_iqa.CnnScorer(path)
    want = np.asarray(ref._fn(ref.params, jnp.asarray(x)))
    ours = iqa.CnnScorer(path, device="cpu")
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    return got, want


def test_hyperiqa_distill_fits_known_teacher(tmp_path):
    from scipy.stats import spearmanr
    n_sigma = 5
    imgs = t_hiqa.blur_corpus()
    train, held = imgs[:4 * n_sigma], imgs[4 * n_sigma:]
    params = t_hiqa.distill(train, t_hiqa._lap_var, steps=260, batch=8, seed=0,
                            channels=(8, 16, 32), log_every=0, device="cpu")
    out = str(tmp_path / "iqa.npz")
    t_hiqa.save_npz(params, out)
    got, want = _both_scores(out, held)
    np.testing.assert_allclose(got, want, **TOL)
    assert spearmanr(got, t_hiqa._lap_var(held)).statistic > 0.8
    for t in range(2):
        per_tex = got[t * n_sigma:(t + 1) * n_sigma]
        assert per_tex[0] > per_tex[-1], per_tex
    assert iqa.CnnScorer(out, "cpu").kind == "distilled-hyperiqa"
    # the reverse: an npz of the JAX tool's schema scores alike in the port
    j_tool = _jax_tool("convert_hyperiqa")
    j_tool.save_npz(j_tool.init_params(jax.random.PRNGKey(3)), str(tmp_path / "jax.npz"))
    np.testing.assert_allclose(*_both_scores(str(tmp_path / "jax.npz"), held), **TOL)


def test_hyperiqa_main_on_twin(tmp_path, upstream_imports):
    from gaussianhaircut_torch.utils.image import write_png
    hq = write_hyperiqa_tree(str(tmp_path))
    frames = tmp_path / "frames"
    rng = np.random.default_rng(0)
    for i in range(4):
        write_png(str(frames / f"{i:06d}.png"), rng.integers(0, 256, (48, 64, 3), np.uint8))
    (frames / "notes.txt").write_text("not a frame")
    out = str(tmp_path / "hyperiqa_distilled.npz")
    assert t_hiqa.main(["--hyperiqa_dir", str(hq), "--frames_dir", str(frames), "--out", out,
                        "--steps", "4", "--batch", "2", "--device", "cpu"]) == 0
    x = t_hiqa.load_frames(str(frames))
    assert x.shape == (4, 224, 224, 3)
    got, want = _both_scores(out, x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
