"""Parity of the port's chamfer distance and self-distilled strand prior with
the JAX package (``ops/chamfer.py``, ``train/prior.py``).

- ``sided_distance`` / ``chamfer_distance``: distances within float32
  (rtol 1e-5, atol 1e-6 x the largest), the same nearest indices, ties
  included (duplicated and integer-grid points, where every distance is
  exact in both packages) and a source count that is not a multiple of the
  block; the chamfer's gradient at the same tolerance.
- ``encode_strands`` at rtol 1e-5 (atol 1e-6 x the largest).
- A few ``distill_strand_prior`` and ``pretrain_strand_decoder`` steps from
  JAX's initial weights (carried across by ``flax_params``, perturbed so
  that every layer carries gradient) with JAX's draws, both packages
  starting from the same non-zero Adam moments (so that Adam's step is no
  sign function of a near-zero gradient): losses and parameters at rtol
  1e-4 / atol 1e-6, the stage steps' tolerance.  The JAX UNet is cut to
  channels (32, 64) by swapping the prior module's ``DiffusionConfig``."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.models import diffusion as jd
from gaussianhaircut_tpu.models import prior_io as j_prior_io
from gaussianhaircut_tpu.models import strand_prior as jsp
from gaussianhaircut_tpu.models.textured_strands import TexturedStrandsConfig as JScfg
from gaussianhaircut_tpu.ops import chamfer as j_chamfer
from gaussianhaircut_tpu.train import optim as j_optim
from gaussianhaircut_tpu.train import prior as j_prior
from gaussianhaircut_torch.models import diffusion as td
from gaussianhaircut_torch.models import flax_params as fp
from gaussianhaircut_torch.models import strand_prior as tsp
from gaussianhaircut_torch.models.textured_strands import TexturedStrandsConfig
from gaussianhaircut_torch.ops import chamfer as t_chamfer
from gaussianhaircut_torch.train import prior as t_prior

STEP_TOL = dict(rtol=1e-4, atol=1e-6)
LENGTH, N_STRANDS, D = 8, 24, 8
SMALL_UNET = dict(mapping_out=64, depths=(1, 1), channels=(32, 64))


def _close(got, ref, atol_of_max=1e-6, rtol=1e-5, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    atol = atol_of_max * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _clouds(kind, rng):
    if kind == "random":
        return (rng.normal(size=(150, 3)).astype(np.float32),
                rng.normal(size=(97, 3)).astype(np.float32))
    if kind == "duplicates":
        # every dst point twice: each minimum is an exact tie
        dst = rng.normal(size=(40, 3)).astype(np.float32)
        return rng.normal(size=(130, 3)).astype(np.float32), np.concatenate([dst, dst[::-1]])
    # small integers: every product and sum is exact, so equidistant
    # neighbours tie exactly in both packages
    return (rng.integers(-3, 4, (150, 3)).astype(np.float32),
            rng.integers(-3, 4, (60, 3)).astype(np.float32))


@pytest.mark.parametrize("kind", ["random", "duplicates", "integer_grid"])
def test_sided_distance_matches_jax(kind):
    """Blocks of 64 (so 150 sources end in a partial block) and the default
    block: distances and the lower index among equal minima."""
    src, dst = _clouds(kind, np.random.default_rng(0))
    for block in (64, 2048):
        d_ref, i_ref = j_chamfer.sided_distance(jnp.asarray(src), jnp.asarray(dst), block=block)
        d, i = t_chamfer.sided_distance(torch.tensor(src), torch.tensor(dst), block=block)
        _close(d.numpy(), d_ref, what=f"{kind} distances")
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref), err_msg=f"{kind} indices")
    if kind != "random":
        assert len(np.unique(np.asarray(i_ref))) < len(src)      # ties were hit


def test_chamfer_and_its_gradient_match_jax():
    src, dst = _clouds("random", np.random.default_rng(1))
    ref, (g_src, g_dst) = jax.value_and_grad(j_chamfer.chamfer_distance, argnums=(0, 1))(
        jnp.asarray(src), jnp.asarray(dst))
    ts, tdst = (torch.tensor(a, requires_grad=True) for a in (src, dst))
    got = t_chamfer.chamfer_distance(ts, tdst)
    gs, gd = torch.autograd.grad(got, (ts, tdst))
    _close(got.detach().numpy(), ref, what="chamfer")
    _close(gs.numpy(), g_src, what="d/dx")
    _close(gd.numpy(), g_dst, what="d/dy")


def _strand_set(rng):
    """World polylines rooted at seeded origins with random orthonormal
    frames, and their uvs."""
    q, _ = np.linalg.qr(rng.normal(size=(N_STRANDS, 3, 3)))
    origins = rng.normal(scale=0.1, size=(N_STRANDS, 1, 3))
    local = np.cumsum(rng.normal(scale=0.01, size=(N_STRANDS, LENGTH, 3)), axis=1)
    local[:, 0] = 0.0
    points = origins + np.einsum("nij,nlj->nli", q, local)
    return (points.astype(np.float32), rng.uniform(size=(N_STRANDS, 2)).astype(np.float32),
            q.astype(np.float32))


def _flat(tree, prefix="x"):
    return j_prior_io._flatten(tree, prefix)


def _jax_encoder(seed=11):
    return jsp.StrandEncoder().init(jax.random.PRNGKey(seed), jnp.zeros((1, LENGTH, 3)))


def _port_module(module, jparams):
    fp.load_flax_(module, _flat(jparams), "x/params")
    return module


def test_encode_strands_matches_jax():
    points, _, l2w = _strand_set(np.random.default_rng(2))
    jenc = _jax_encoder()
    z_ref, v_ref = j_prior.encode_strands(jenc, jnp.asarray(points), jnp.asarray(points[:, :1]),
                                          jnp.asarray(l2w), 10.0)
    enc = _port_module(tsp.StrandEncoder(length=LENGTH), jenc)
    pts = torch.tensor(points)
    z, v = t_prior.encode_strands(enc, pts, pts[:, :1], torch.tensor(l2w), 10.0)
    _close(z.detach().numpy(), z_ref, what="z_geom")
    _close(v.numpy(), v_ref, what="v_local")
    # the seeded fixed encoder is flax's init law from a torch generator:
    # another stream, the same layout
    layout = lambda flat: {k: v.shape for k, v in flat.items()}
    assert layout(fp.to_flax(t_prior.fixed_encoder(LENGTH), prefix="x/params")) == layout(
        _flat(jenc))


def _perturb(tree, rng, scale):
    return jax.tree.map(lambda x: np.asarray(x) + scale * rng.normal(size=x.shape).astype(
        np.float32), tree)


def _moments(tree, rng):
    """Non-zero Adam moments of ``tree``'s shapes and a count of 7."""
    mu = jax.tree.map(lambda x: 1e-3 * rng.normal(size=x.shape).astype(np.float32), tree)
    nu = jax.tree.map(lambda x: (1e-3 * rng.normal(size=x.shape)).astype(np.float32) ** 2
                      + 1e-8, tree)
    return mu, nu


def _patch_adam(monkeypatch, mu, nu, module, prefix=""):
    """Both packages' prior modules start Adam from the moments ``mu, nu``
    (flax trees) with a count of 7."""
    monkeypatch.setattr(j_prior, "optim", types.SimpleNamespace(
        adam_init=lambda p: j_optim.AdamState(mu, nu, jnp.asarray(7, jnp.int32)),
        adam_update=j_optim.adam_update))
    to_port = lambda tree: {prefix + k: v for k, v in fp.from_flax(
        module, _flat(tree), "x/params").items()}
    t_optim = t_prior.optim
    monkeypatch.setattr(t_prior, "optim", types.SimpleNamespace(
        adam_init=lambda p: t_optim.AdamState(
            to_port(mu), to_port(nu), torch.tensor(7, dtype=torch.int32)),
        adam_update=t_optim.adam_update))


def test_distill_strand_prior_steps_match_jax(monkeypatch):
    steps, guide, seed = 3, 16, 5
    rng = np.random.default_rng(3)
    points, uvs, l2w = _strand_set(rng)
    cfg = functools.partial(jd.DiffusionConfig, **SMALL_UNET)
    key = jax.random.PRNGKey(seed)
    jden = jd.Denoiser(cfg(input_channels=64, input_size=D))
    init = _perturb(jden.init(jax.random.fold_in(key, 0)), rng, 0.03)

    class PerturbedDenoiser(jd.Denoiser):
        def init(self, key):
            return init

    monkeypatch.setattr(j_prior, "DiffusionConfig", cfg)
    monkeypatch.setattr(j_prior, "Denoiser", PerturbedDenoiser)
    tden = td.Denoiser(td.DiffusionConfig(input_size=D, **SMALL_UNET))
    _port_module(tden.net, init)
    mu, nu = _moments(init, rng)
    _patch_adam(monkeypatch, mu, nu, tden.net, prefix="net.")

    # JAX's draws, as distill_strand_prior makes them (prior.py:115-121)
    draws = []
    for i in range(steps):
        k_lat, k_noise, k_sig = jax.random.split(jax.random.fold_in(key, 1 + i), 3)
        draws.append(t_prior.PriorDraws(*(torch.tensor(np.asarray(a)) for a in (
            jax.random.randint(k_lat, (guide,), 0, N_STRANDS),
            jax.random.normal(k_noise, (1, D, D, 64)),
            jden.sample_density(k_sig, (1,))))))
    losses = []
    jprior, jinfo = j_prior.distill_strand_prior(
        jnp.asarray(points), jnp.asarray(uvs), jnp.asarray(l2w), JScfg(diffusion_input=D),
        steps=steps, key=key, num_guiding=guide,
        progress_callback=lambda i, lv: losses.append(lv))
    tlosses = []
    tprior, tinfo = t_prior.distill_strand_prior(
        points, uvs, l2w, TexturedStrandsConfig(diffusion_input=D), steps=steps,
        encoder=_port_module(tsp.StrandEncoder(length=LENGTH), jprior["encoder"]),
        denoiser=tden, draws=draws, num_guiding=guide, device="cpu",
        progress_callback=lambda i, lv: tlosses.append(lv))
    np.testing.assert_allclose(tlosses, losses, **STEP_TOL)
    assert set(tinfo) == set(jinfo) and tinfo["prior_steps"] == steps
    got = fp.to_flax(tprior["denoiser"].net, prefix="x/params")
    for k, ref in _flat(jprior["denoiser"]).items():
        np.testing.assert_allclose(got[k], ref, err_msg=k, **STEP_TOL)
    assert not np.allclose(got["x/params/Conv_0/kernel"], _flat(init)["x/params/Conv_0/kernel"])


def test_pretrain_strand_decoder_steps_match_jax(monkeypatch):
    steps, batch, seed = 3, 10, 6
    rng = np.random.default_rng(4)
    points, _, l2w = _strand_set(rng)
    key = jax.random.PRNGKey(seed)
    jdec = jsp.StrandDecoder(length=LENGTH)
    init = jdec.init(jax.random.fold_in(key, 0), jnp.zeros((1, 64)))

    tdec = _port_module(tsp.StrandDecoder(length=LENGTH), init)
    mu, nu = _moments(init, rng)
    _patch_adam(monkeypatch, mu, nu, tdec)
    draws = [torch.tensor(np.asarray(jax.random.randint(jax.random.fold_in(key, 1 + i),
                                                        (batch,), 0, N_STRANDS)))
             for i in range(steps)]
    jout, jinfo = j_prior.pretrain_strand_decoder(
        jnp.asarray(points), jnp.asarray(l2w), JScfg(), steps=steps, key=key, batch=batch)
    tout, tinfo = t_prior.pretrain_strand_decoder(
        points, l2w, TexturedStrandsConfig(), steps=steps, batch=batch,
        encoder=_port_module(tsp.StrandEncoder(length=LENGTH), _jax_encoder()),
        decoder=tdec, draws=draws, device="cpu")
    assert set(tinfo) == set(jinfo)
    for k in ("decoder_pretrain_loss_start", "decoder_pretrain_loss_end"):
        np.testing.assert_allclose(tinfo[k], jinfo[k], rtol=1e-4, atol=1e-5, err_msg=k)
    got = fp.to_flax(tout["decoder"], prefix="x/params")
    for k, ref in _flat(jout["decoder"]).items():
        np.testing.assert_allclose(got[k], ref, err_msg=k, **STEP_TOL)


def test_prior_runs_from_its_own_draws():
    """Without draws or weights: the seeded fixed encoder and fresh
    networks, a loss that is finite, modules of the prior file's layout."""
    points, uvs, l2w = _strand_set(np.random.default_rng(5))
    scfg = TexturedStrandsConfig(diffusion_input=4)
    fresh = lambda: td.Denoiser(td.DiffusionConfig(input_size=4, **SMALL_UNET)).init_weights(
        torch.Generator().manual_seed(0))
    prior, info = t_prior.distill_strand_prior(points, uvs, l2w, scfg, steps=2, seed=1,
                                               denoiser=fresh(), device="cpu")
    assert set(prior) == {"encoder", "denoiser"} and np.isfinite(info["prior_loss_end"])
    _, info2 = t_prior.distill_strand_prior(points, uvs, l2w, scfg, steps=2, seed=1,
                                            denoiser=fresh(), device="cpu")
    assert info2 == info                               # one seed, one run
    dec, dinfo = t_prior.pretrain_strand_decoder(points, l2w, scfg, steps=2, device="cpu")
    assert np.isfinite(dinfo["decoder_pretrain_loss_end"]) and dec["decoder"].length == LENGTH
