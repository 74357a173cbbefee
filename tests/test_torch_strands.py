"""Parity of the port's strand modules with the JAX package: the strand and
colour networks and the UNet denoiser (weights carried across from flax),
``Denoiser.loss``, ``sds_latent_image``, the texture sampler, the strand
generator at given roots, ``strands_to_gaussians``, ``parallel_transport``,
the scalp pools, the AdamW / clipping helpers and the prior files both ways.

Inputs come from numpy seeds.  Tolerances: atol 1e-5 x max|ref| + rtol 1e-4
for the networks (float32 matrix products and convolutions summed in
another order); rtol 1e-5 / atol 1e-6 for the elementwise maths (the same
formulas in float32, atol taken as 1e-6 x max|ref|); exact equality where
both run the same numpy code.  The JAX side runs under jit."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.models import diffusion as jd
from gaussianhaircut_tpu.models import prior_io as j_prior_io
from gaussianhaircut_tpu.models import strand_prior as jsp
from gaussianhaircut_tpu.models import strands as j_strands
from gaussianhaircut_tpu.models import textured_strands as jts
from gaussianhaircut_tpu.ops import quaternion as j_quat
from gaussianhaircut_tpu.train import optim as j_optim
from gaussianhaircut_tpu.utils import mesh as j_mesh
from gaussianhaircut_torch.models import diffusion as td
from gaussianhaircut_torch.models import flax_params as fp
from gaussianhaircut_torch.models import prior_io as t_prior_io
from gaussianhaircut_torch.models import strand_prior as tsp
from gaussianhaircut_torch.models import strands as t_strands
from gaussianhaircut_torch.models import textured_strands as tts
from gaussianhaircut_torch.ops import quaternion as t_quat
from gaussianhaircut_torch.train import optim as t_optim
from gaussianhaircut_torch.utils import mesh as t_mesh

NET_TOL = dict(atol_of_max=1e-5, rtol=1e-4)
EW_TOL = dict(atol_of_max=1e-6, rtol=1e-5)
LENGTH = 8
SMALL_UNET = dict(input_channels=64, input_size=8, mapping_out=64, depths=(1, 1),
                  channels=(32, 64))


def _close(got, ref, atol_of_max=1e-5, rtol=1e-4, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    atol = atol_of_max * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _flat(tree, prefix="x"):
    return j_prior_io._flatten(tree, prefix)


def _perturbed(params, rng, scale=0.05):
    """Every leaf plus seeded noise, so that zero-initialised layers (the
    UNet's last convolution) carry gradient."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(treedef, [
        x + scale * rng.normal(size=x.shape).astype(np.float32) for x in leaves])


def _net_cases():
    return {
        "decoder": (jsp.StrandDecoder(length=LENGTH), tsp.StrandDecoder(length=LENGTH),
                    (5, 64)),
        "encoder": (jsp.StrandEncoder(), tsp.StrandEncoder(length=LENGTH), (5, LENGTH, 3)),
        "color": (jsp.ColorDecoder(sh_degree=2), tsp.ColorDecoder(sh_degree=2), (5, 64)),
        "mlp": (jsp.MLP((32, 16, 7)), tsp.MLP(10, (32, 16, 7)), (5, 10)),
    }


@pytest.mark.parametrize("name", ["decoder", "encoder", "color", "mlp"])
def test_networks_match_jax(name):
    """Weights carried across: the forward and the gradient of a seeded
    weighted sum with respect to the input and to every weight."""
    jmod, tmod, shape = _net_cases()[name]
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    jparams = _perturbed(jmod.init(jax.random.PRNGKey(0), x), rng)
    fp.load_flax_(tmod, _flat(jparams), "x/params")
    y_ref = np.asarray(jmod.apply(jparams, x))
    w = rng.normal(size=y_ref.shape).astype(np.float32)

    jg_p, jg_x = jax.jit(jax.grad(lambda p, xx: jnp.sum(jmod.apply(p, xx) * w),
                                  argnums=(0, 1)))(jparams, x)
    xt = torch.tensor(x, requires_grad=True)
    y = tmod(xt)
    _close(y.detach().numpy(), y_ref, **NET_TOL, what="forward")
    tg = torch.autograd.grad(torch.sum(y * torch.tensor(w)), [xt] + list(tmod.parameters()))
    _close(tg[0].numpy(), jg_x, **NET_TOL, what="input gradient")
    g_port = fp.to_flax(tmod, dict(zip([n for n, _ in tmod.named_parameters()], tg[1:])),
                        prefix="x/params")
    for k, ref in _flat(jg_p).items():
        _close(g_port[k], ref, **NET_TOL, what=k)


def test_flax_carry_round_trip_and_checks():
    """Port -> flax -> port is exact; a missing key or a wrong shape raises."""
    den = td.Denoiser(td.DiffusionConfig(**SMALL_UNET)).init_weights(
        torch.Generator().manual_seed(0))
    flat = fp.to_flax(den.net)
    back = fp.from_flax(den.net, flat)
    for n, p in den.net.named_parameters():
        assert torch.equal(back[n], p.detach()), n
    assert any(k.endswith("GroupNorm_0/scale") for k in flat)
    conv = flat["params/ResConvBlock_0/Conv_0/kernel"]
    assert conv.shape == (3, 3, 64, 32)                  # HWIO
    with pytest.raises(ValueError, match="missing"):
        fp.from_flax(den.net, {k: v for k, v in flat.items() if "Conv_0/kernel" not in k})
    bad = dict(flat)
    bad["params/Dense_0/kernel"] = bad["params/Dense_0/kernel"][:-1]
    with pytest.raises(ValueError, match="shape"):
        fp.from_flax(den.net, bad)


def test_fresh_init_uses_flax_distributions():
    """The port draws flax's initialisers (the streams differ, the laws do
    not): lecun-normal kernels truncated at 2 sigma with zero biases, the
    decoder's last layer at normal(1e-2), the UNet's last conv at zero,
    FourierFeatures' w at normal(1), the texture at 0.01 normal."""
    gen = torch.Generator().manual_seed(3)
    cfg = dict(depths=(2, 1), channels=(128, 256))
    den = td.Denoiser(td.DiffusionConfig(**cfg)).init_weights(gen)
    w = den.net.down[2].conv1.weight.detach()              # fan_in 128 x 9
    std = (1.0 / (128 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.02 and float(w.abs().max()) <= 2 * std / 0.8796 + 1e-7
    assert float(w.mean()) < 0.02 * std
    assert not den.net.out.weight.any() and not den.net.down[2].conv1.bias.any()
    assert abs(float(den.net.fourier.w.detach().std()) - 1) < 0.8    # 8 draws of normal(1)
    dec = tsp.StrandDecoder().init_weights(gen)
    assert abs(float(dec.out.weight.detach().std()) / 1e-2 - 1) < 0.1
    assert abs(float(dec.hidden1.weight.detach().std()) * 16 - 1) < 0.05   # fan_in 256
    tex = tts.init_params(tts.TexturedStrandsConfig(texture_size=64), gen).texture
    tex = tex.detach()
    assert abs(float(tex.std()) / 0.01 - 1) < 0.01 and abs(float(tex.mean())) < 1e-4
    # flax's GroupNorm: epsilon 1e-6, 32 groups where the channels divide by 32
    assert all(m.eps == 1e-6 and m.num_groups == 32 for m in den.modules()
               if isinstance(m, torch.nn.GroupNorm))
    assert td.ResConvBlock(48, 32, 16).norm.num_groups == 1
    # the same law as flax's on the same shape
    jw = jax.jit(jd.UNetV1(jd.DiffusionConfig(**cfg)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 64)), jnp.ones((1,)))
    jconv = np.asarray(jw["params"]["ResConvBlock_2"]["Conv_0"]["kernel"])
    assert abs(float(jconv.std()) / float(w.std()) - 1) < 0.03


def test_denoiser_loss_matches_jax():
    """Denoiser.loss (the UNet under EDM preconditioning, weights carried
    across) at given noise and sigma, masked and unmasked: the value and its
    gradient with respect to the clean latent.  The UNet's weight gradients
    are held by the stage-2 step's parity (tests/test_torch_stage2.py)."""
    rng = np.random.default_rng(2)
    cfg = dict(SMALL_UNET)
    jden = jd.Denoiser(jd.DiffusionConfig(**cfg))
    jparams = _perturbed(jden.init(jax.random.PRNGKey(1)), rng)
    tden = td.Denoiser(td.DiffusionConfig(**cfg))
    fp.load_flax_(tden.net, _flat(jparams), "x/params")
    noise = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    sigma = np.asarray([0.05, 3.0], np.float32)
    mask = (rng.uniform(size=(2, 8, 8, 1)) > 0.3).astype(np.float32)
    # latents of unit scale, and of the texture's (0.01): there GroupNorm's
    # epsilon is a visible part of the variance
    for scale, m in ((1.0, None), (1.0, mask), (0.01, None)):
        x0 = scale * rng.normal(size=noise.shape).astype(np.float32)
        ref, g_ref = jax.jit(jax.value_and_grad(
            lambda x: jden.loss(jparams, x, noise, sigma, m)))(x0)
        xt = torch.tensor(x0, requires_grad=True)
        got = tden.loss(xt, torch.tensor(noise), torch.tensor(sigma),
                        None if m is None else torch.tensor(m))
        g, = torch.autograd.grad(got, xt)
        _close(got.detach().numpy(), ref, **NET_TOL, what="loss")
        _close(g.numpy(), g_ref, **NET_TOL, what="dloss/dx0")


def test_sds_latent_image_matches_jax():
    """The k-NN resampling with ties (duplicated guiding UVs: top_k's
    lower-index-first order) and the diagonal-inclusive cosine blend; the
    value and the gradients with respect to the latents and directions."""
    rng = np.random.default_rng(3)
    g, s = 40, LENGTH - 1
    z = rng.normal(size=(g, 64)).astype(np.float32)
    uvs = rng.uniform(-1, 1, size=(g, 2)).astype(np.float32)
    uvs[5] = uvs[3]
    uvs[9] = uvs[3]
    v = rng.normal(size=(g, s, 3)).astype(np.float32)
    v[:10] = v[0] + 0.05 * v[:10]                # similar directions: the other branch
    w = rng.normal(size=(8, 8, 64)).astype(np.float32)
    f = lambda zz, vv: jnp.sum(jd.sds_latent_image(zz, uvs, vv, 8) * w)
    ref = np.asarray(jax.jit(lambda zz, vv: jd.sds_latent_image(zz, uvs, vv, 8))(z, v))
    gz_ref, gv_ref = jax.jit(jax.grad(f, argnums=(0, 1)))(z, v)
    zt, vt = torch.tensor(z, requires_grad=True), torch.tensor(v, requires_grad=True)
    out = td.sds_latent_image(zt, torch.tensor(uvs), vt, 8)
    _close(out.detach().numpy(), ref, 1e-6, 1e-5, what="image")
    gz, gv = torch.autograd.grad(torch.sum(out * torch.tensor(w)), [zt, vt])
    _close(gz.numpy(), gz_ref, 1e-6, 1e-5, what="d/dz")
    _close(gv.numpy(), gv_ref, 1e-5, 1e-4, what="d/dv")


def test_sample_texture_and_generate_strands_match_jax():
    """The bilinear texture read (edges included) and the generator at the
    JAX package's roots: world and local points, codes and label."""
    rng = np.random.default_rng(4)
    scfg = jts.TexturedStrandsConfig(num_strands=16, texture_size=16, strand_length=LENGTH,
                                     pool_size=300)
    tcfg = tts.TexturedStrandsConfig(**dataclasses.asdict(scfg))
    tex = rng.normal(size=(16, 16, 129)).astype(np.float32)
    uvs = np.concatenate([rng.uniform(size=(20, 2)), [[0, 0], [1, 1], [0, 1]]]).astype(np.float32)
    _close(tts.sample_texture(torch.tensor(tex), torch.tensor(uvs)).numpy(),
           jts.sample_texture(tex, uvs), **EW_TOL)

    jpool = jts.synthetic_scalp_pool(300, seed=2)
    tpool = tts.synthetic_scalp_pool(300, seed=2)
    jparams = jts.init_params(scfg, jax.random.PRNGKey(0))
    jparams["decoder"] = _perturbed(jparams["decoder"], rng, 0.02)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, k: jts.generate_strands(p, jpool, scfg, k))(jparams, key)
    roots = np.asarray(jax.random.choice(key, 300, (16,), replace=False))
    dec = tsp.StrandDecoder(length=LENGTH)
    fp.load_flax_(dec, _flat(jparams["decoder"]), "x/params")
    params = tts.StrandParams(torch.tensor(np.asarray(jparams["texture"])), dec)
    out = tts.generate_strands(params, tpool, tcfg, torch.tensor(roots))
    for name in ref._fields:
        _close(getattr(out, name).detach().numpy(), getattr(ref, name), 1e-5, 1e-4, what=name)
    distinct = tts.sample_roots(tpool, 16, torch.Generator().manual_seed(0))
    assert len(set(distinct.tolist())) == 16 and int(distinct.max()) < 300


def test_strands_to_gaussians_and_parallel_transport_match_jax():
    """Midpoints, quaternions (unnormalized), rotation matrices and scales,
    and their gradients, with one exactly antipodal segment (a zero
    quaternion, the identity rotation with finite gradients)."""
    rng = np.random.default_rng(5)
    pts = np.cumsum(rng.normal(scale=0.01, size=(4, LENGTH, 3)), axis=1).astype(np.float32)
    pts[0, 1] = pts[0, 0] + np.asarray([-0.01, 0.0, 0.0], np.float32)
    ref = jax.jit(lambda p: j_strands.strands_to_gaussians(p, 2e-3))(pts)
    pt = torch.tensor(pts, requires_grad=True)
    out = t_strands.strands_to_gaussians(pt, 2e-3)
    for name in ref._fields:
        _close(getattr(out, name).detach().numpy(), getattr(ref, name), 1e-6, 1e-5, what=name)
    w = rng.normal(size=(4 * (LENGTH - 1), 3, 3)).astype(np.float32)
    g_ref = jax.jit(jax.grad(
        lambda p: jnp.sum(j_strands.strands_to_gaussians(p, 2e-3).rotation_matrix * w)
        + jnp.sum(j_strands.strands_to_gaussians(p, 2e-3).scaling)))(pts)
    g, = torch.autograd.grad(torch.sum(out.rotation_matrix * torch.tensor(w))
                             + torch.sum(out.scaling), pt)
    assert np.isfinite(g.numpy()).all()
    _close(g.numpy(), g_ref, 1e-5, 1e-4, what="d/dpoints")
    a = rng.normal(size=(6, 3)).astype(np.float32)
    b = rng.normal(size=(6, 3)).astype(np.float32)
    _close(t_quat.parallel_transport(torch.tensor(a), torch.tensor(b)).numpy(),
           j_quat.parallel_transport(a, b), **EW_TOL)


def _write_obj(path, with_uv: bool):
    """A bumpy 5x4 grid of quads (fan-triangulated on load)."""
    rng = np.random.default_rng(6)
    lines = []
    for j in range(4):
        for i in range(5):
            lines.append(f"v {i * 0.1} {0.02 * rng.normal()} {j * 0.1}")
            if with_uv:
                lines.append(f"vt {i / 4} {j / 3}")
    for j in range(3):
        for i in range(4):
            a, b, c, d = (j * 5 + i + 1, j * 5 + i + 2, (j + 1) * 5 + i + 2, (j + 1) * 5 + i + 1)
            lines.append("f " + " ".join(f"{x}/{x}" if with_uv else str(x) for x in (a, b, c, d)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("with_uv", [True, False])
def test_scalp_pools_match_jax(tmp_path, with_uv):
    """ScalpPool.from_mesh on a small OBJ (with and without UVs, whole and
    cut to some vertices) and synthetic_scalp_pool: both packages build the
    same pool from one seed."""
    path = str(tmp_path / "scalp.obj")
    _write_obj(path, with_uv)
    jm, tm = j_mesh.load_obj(path), t_mesh.load_obj(path)
    for a, b in zip(jm, tm):
        assert (a is None and b is None) or np.array_equal(a, b)
    for ids in (None, list(range(0, 15))):
        ref = jts.ScalpPool.from_mesh(jm, 400, seed=3, scalp_vert_ids=ids)
        got = tts.ScalpPool.from_mesh(tm, 400, seed=3, scalp_vert_ids=ids)
        for name in ref._fields:
            assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name))), name
    ref = jts.synthetic_scalp_pool(500, seed=4)
    got = tts.synthetic_scalp_pool(500, seed=4)
    for name in ref._fields:
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name))), name


def test_optim_helpers_match_jax():
    """adamw_update (decay on every leaf, with the lr; its own count),
    clip_by_global_norm (above and below the threshold) and
    cap_norm_relative, on dict trees."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    r = lambda: {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params, grads, mu, nu_raw = r(), r(), r(), r()
    nu = {k: np.abs(v) * 1e-3 for k, v in nu_raw.items()}
    jstate = j_optim.AdamState(mu, nu, jnp.asarray(6, jnp.int32))
    tstate = t_optim.AdamState({k: torch.tensor(v) for k, v in mu.items()},
                               {k: torch.tensor(v) for k, v in nu.items()},
                               torch.tensor(6, dtype=torch.int32))
    t = lambda d: {k: torch.tensor(v) for k, v in d.items()}
    ju, jst = j_optim.adamw_update(grads, jstate, params, 3e-3)
    tu, tst = t_optim.adamw_update(t(grads), tstate, t(params), 3e-3)
    assert int(tst.count) == 7
    for k in shapes:
        _close(tu[k].numpy(), ju[k], 1e-6, 1e-5, what=f"update {k}")
        _close(tst.mu[k].numpy(), jst.mu[k], 1e-6, 1e-5, what=f"mu {k}")
        _close(tst.nu[k].numpy(), jst.nu[k], 1e-6, 1e-5, what=f"nu {k}")
    for max_norm in (0.5, 100.0):
        jc, jn = j_optim.clip_by_global_norm(grads, max_norm)
        tc, tn = t_optim.clip_by_global_norm(t(grads), max_norm)
        _close(tn.numpy(), jn, **EW_TOL)
        for k in shapes:
            _close(tc[k].numpy(), jc[k], **EW_TOL)
    for ratio in (0.1, 10.0):
        jc, js = j_optim.cap_norm_relative(grads, params, ratio)
        tc, ts = t_optim.cap_norm_relative(t(grads), t(params), ratio)
        _close(ts.numpy(), js, **EW_TOL)
        for k in shapes:
            _close(tc[k].numpy(), jc[k], **EW_TOL)


@functools.lru_cache(maxsize=1)
def _jax_prior():
    rng = np.random.default_rng(8)
    return {
        "encoder": _perturbed(jsp.StrandEncoder().init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, LENGTH, 3))), rng),
        "decoder": _perturbed(jsp.StrandDecoder(length=LENGTH).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 64))), rng),
        "denoiser": _perturbed(jd.Denoiser(jd.DiffusionConfig(**SMALL_UNET)).init(
            jax.random.PRNGKey(2)), rng),
    }


def test_prior_files_both_ways(tmp_path):
    """A prior written by the JAX package loads into the port at its own
    widths (a small UNet, strands of 8) and computes what the JAX modules
    compute (``encode_strands`` included); the port's file loads back into
    the JAX package unchanged."""
    jprior = _jax_prior()
    j_prior_io.save_prior(str(tmp_path / "j.npz"), jprior)
    tprior = t_prior_io.load_strand_prior(str(tmp_path / "j.npz"), strand_length=LENGTH,
                                          diffusion_input=8)
    assert tprior["denoiser"].cfg.channels == (32, 64) and tprior["denoiser"].cfg.depths == (1, 1)
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(3, LENGTH, 3)).astype(np.float32)
    _close(tprior["encoder"](torch.tensor(pts)).detach().numpy(),
           jsp.StrandEncoder().apply(jprior["encoder"], pts), **NET_TOL)
    scfg = jts.TexturedStrandsConfig(strand_length=LENGTH)
    _close(tts.encode_strands(tprior["encoder"], torch.tensor(pts), scfg).detach().numpy(),
           jts.encode_strands(jprior["encoder"], pts, scfg), **NET_TOL, what="encode_strands")
    z = rng.normal(size=(3, 64)).astype(np.float32)
    _close(tprior["decoder"](torch.tensor(z)).detach().numpy(),
           jsp.StrandDecoder(length=LENGTH).apply(jprior["decoder"], z), **NET_TOL)
    x = rng.normal(size=(1, 8, 8, 64)).astype(np.float32)
    s = np.asarray([0.7], np.float32)
    _close(tprior["denoiser"].denoise(torch.tensor(x), torch.tensor(s)).detach().numpy(),
           jd.Denoiser(jd.DiffusionConfig(**SMALL_UNET)).denoise(jprior["denoiser"], x, s),
           **NET_TOL)

    t_prior_io.save_prior(str(tmp_path / "t.npz"), tprior)
    back = j_prior_io.load_prior(str(tmp_path / "t.npz"))
    for name in ("encoder", "decoder", "denoiser"):
        ref = _flat(jprior[name])
        got = _flat(back[name])
        assert set(got) == set(ref)
        for k in ref:
            assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


def test_init_prior_has_the_jax_layout():
    """A fresh prior from each package has the same keys and shapes (the
    JAX side by shape evaluation only)."""
    scfg = jts.TexturedStrandsConfig(strand_length=LENGTH, diffusion_input=8)
    abstract = jax.eval_shape(lambda: j_prior_io.init_prior(scfg, jax.random.PRNGKey(7)))
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]:
        ref["/".join(p.key for p in path)] = tuple(leaf.shape)
    got = t_prior_io.init_prior(tts.TexturedStrandsConfig(strand_length=LENGTH,
                                                          diffusion_input=8),
                                torch.Generator().manual_seed(7))
    shapes = {}
    for s, mod in got.items():
        for k, v in fp.to_flax(mod.net if s == "denoiser" else mod, prefix=s + "/params").items():
            shapes[k] = tuple(v.shape)
    assert shapes == ref
