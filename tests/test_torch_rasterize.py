"""Parity of the port's rasterizer with the JAX package on the
tests/test_rasterize.py scene (64 Gaussians, 40x24, tile 8, chunk 16):
binning, both kernels' plain versions against the interpret-mode Pallas
kernels, and ``rasterize()`` forward and gradients.  The port's
exact-skip binning composites the pairs of the 3-sigma rect, which the JAX
package's drops some of (``tests/exact_skip.py``), so its binning and its
render are held to the JAX package's 3-sigma binning."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.ops.rasterize import common as JC
from gaussianhaircut_tpu.ops.rasterize import pallas_core
from gaussianhaircut_tpu.ops.rasterize.api import (
    _disassemble_cotangent, ndc_xy_to_pixel as j_ndc_xy_to_pixel,
    rasterize as j_rasterize,
)
from gaussianhaircut_torch.ops.rasterize import common as TC
from gaussianhaircut_torch.ops.rasterize import plain_core
from gaussianhaircut_torch.ops.rasterize.api import rasterize as t_rasterize
from tests.exact_skip import candidate, jax_3sigma_binning

W, H = 40, 24
NCH = 10
# forward / gradient tolerances of tests/test_rasterize.py:166,215 (the
# Pallas kernel's log-space transmittance and bf16-split matmuls round
# differently from the linear-domain plain version)
FWD_TOL = dict(rtol=5e-4, atol=5e-3)
BWD_TOL = dict(rtol=5e-3, atol=1e-3)


def make_scene(rng, p=64):
    """The tests/test_rasterize.py scene: random Gaussians around the image,
    some near-culled, some externally invalid."""
    mean_pix = rng.uniform([-5, -5], [W + 5, H + 5], size=(p, 2)).astype(np.float32)
    theta = rng.uniform(0, np.pi, p)
    s1 = rng.uniform(1.0, 16.0, p)
    s2 = rng.uniform(1.0, 16.0, p)
    c, s = np.cos(theta), np.sin(theta)
    cov00 = c * c * s1 + s * s * s2
    cov01 = c * s * s1 - s * c * s2
    cov11 = s * s * s1 + c * c * s2
    det = cov00 * cov11 - cov01 ** 2
    conic = np.stack([cov11 / det, -cov01 / det, cov00 / det], -1).astype(np.float32)
    colors = rng.uniform(0, 1, size=(p, NCH)).astype(np.float32)
    opacity = rng.uniform(0.05, 1.0, size=(p, 1)).astype(np.float32)
    depth = rng.uniform(0.5, 10.0, size=(p,)).astype(np.float32)
    depth[: p // 8] = 0.1
    valid = np.ones(p, bool)
    valid[p // 8: p // 4] = False
    bg = np.array([1, 1, 1, 0, 0, 0, 0, 0, 0, 100], np.float32)
    size = np.array([W, H], np.float32)
    ndc_xy = (2.0 * mean_pix + 1.0) / size - 1.0
    ndc = np.concatenate([ndc_xy, np.zeros_like(ndc_xy[:, :1])], -1).astype(np.float32)
    return ndc, conic, colors, opacity, depth, valid, bg


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.default_rng(7))


@pytest.fixture(scope="module")
def jcfg():
    return JC.RasterConfig(tile_w=8, tile_h=8, chunk=16, capacity_mult=16,
                           sort_mode="exact")


@pytest.fixture(scope="module")
def tcfg():
    return TC.RasterConfig(tile_w=8, tile_h=8, chunk=16)


def _jax_bin(scene, jcfg, exact_skip=True):
    ndc, conic, colors, opacity, depth, valid, _ = scene
    mean_pix = j_ndc_xy_to_pixel(jnp.asarray(ndc), W, H)
    pre = JC.preprocess(mean_pix, jnp.asarray(conic), jnp.asarray(depth),
                        jnp.asarray(valid), W, H, jcfg,
                        opacity=jnp.asarray(opacity) if exact_skip else None)
    return JC.bin_instances(pre, mean_pix, jnp.asarray(conic),
                            jnp.asarray(opacity), jnp.asarray(colors),
                            jnp.asarray(depth), W, H, jcfg)


@pytest.fixture(scope="module")
def jax_binned(scene, jcfg):
    return _jax_bin(scene, jcfg)


@pytest.fixture(scope="module")
def pallas_fwd(jax_binned, jcfg):
    return np.array(pallas_core.raster_core_pallas_fwd(
        jax_binned, W, H, jcfg, interpret=True))


def _tile_chunk_ranges(tile_of_chunk: torch.Tensor, chunk_in_tile: torch.Tensor,
                      num_tiles: int):
    """(chunk_start, nchunks) int32 [T] from a (tile_of_chunk, chunk_in_tile)
    layout such as the JAX package's ``Binned``."""
    used = chunk_in_tile >= 0
    tiles = tile_of_chunk.long()[used]
    nchunks = torch.bincount(tiles, minlength=num_tiles)
    first = torch.nonzero(used & (chunk_in_tile == 0))[:, 0]
    chunk_start = torch.zeros(num_tiles, dtype=torch.int64, device=tiles.device)
    chunk_start[tile_of_chunk.long()[first]] = first
    return chunk_start.to(torch.int32), nchunks.to(torch.int32)


def _torch_layout(jb):
    """The JAX layout as torch tensors + per-tile chunk ranges."""
    tof = torch.from_numpy(np.array(jb.tile_of_chunk))
    kit = torch.from_numpy(np.array(jb.chunk_in_tile))
    cs, nc = _tile_chunk_ranges(tof, kit, jb.num_tiles)
    return torch.from_numpy(np.array(jb.payload)), cs, nc


def _per_tile(payload, gid, tof, kit, num_tiles, p):
    """{tile: (gids in order, payload columns)} over the filled slots."""
    out = {}
    for t in range(num_tiles):
        chunks = [c for c in range(len(tof)) if tof[c] == t and kit[c] >= 0]
        chunks.sort(key=lambda c: kit[c])
        g = np.concatenate([gid[c] for c in chunks])
        cols = np.concatenate([payload[c][:18].T for c in chunks])
        out[t] = (g[g < p], cols[g < p])
    return out


def _port_bin(scene, tcfg, exact_skip):
    ndc, conic, colors, opacity, depth, valid, _ = scene
    t = {k: torch.from_numpy(v) for k, v in zip(
        ("ndc", "conic", "colors", "opacity", "depth", "valid"),
        (ndc, conic, colors, opacity, depth, valid))}
    mean_pix = ((t["ndc"][:, :2] + 1.0) * torch.tensor([W, H], dtype=torch.float32) - 1.0) * 0.5
    pre = TC.preprocess(mean_pix, t["conic"], t["depth"], t["valid"], W, H, tcfg,
                        opacity=t["opacity"] if exact_skip else None)
    return mean_pix, TC.bin_instances(pre, mean_pix, t["conic"], t["opacity"], t["colors"],
                                      t["depth"], W, H, tcfg)


def _lists(b, p):
    return _per_tile(np.asarray(b.payload), np.asarray(b.gid), np.asarray(b.tile_of_chunk),
                     np.asarray(b.chunk_in_tile), b.num_tiles, p)


def test_binning_matches_jax_exact_sort(scene, tcfg, jcfg, jax_binned):
    """The 3-sigma binning (no ``opacity`` on either side) equals the JAX
    package's tile by tile: the same instances in the same depth order with
    the same payload columns.  The exact-skip binning's tile lists are the
    3-sigma lists with the instances left out that pass the kernels' alpha
    test at no pixel of their tile, in the same order; they hold every
    instance of the JAX package's exact-skip lists that passes it (where a
    scene reaches the defect, the JAX package's lists lack some such
    instances, and the port's hold them)."""
    p = scene[0].shape[0]
    _, tb3 = _port_bin(scene, tcfg, exact_skip=False)
    jb3 = _jax_bin(scene, jcfg, exact_skip=False)
    assert tb3.num_rendered == int(jb3.num_rendered)
    ours3, ref3 = _lists(tb3, p), _lists(jb3, p)
    for tile in range(tb3.num_tiles):
        np.testing.assert_array_equal(ours3[tile][0], ref3[tile][0], err_msg=f"tile {tile}")
        np.testing.assert_allclose(ours3[tile][1], ref3[tile][1], rtol=1e-6, atol=1e-6)
    for tb in (tb3, _port_bin(scene, tcfg, exact_skip=True)[1]):
        # the per-tile ranges agree with the (tile_of_chunk, chunk_in_tile) view
        cs, nc = _tile_chunk_ranges(tb.tile_of_chunk, tb.chunk_in_tile, tb.num_tiles)
        np.testing.assert_array_equal(cs.numpy(), tb.chunk_start.numpy())
        np.testing.assert_array_equal(nc.numpy(), tb.nchunks.numpy())

    mean_pix, tb = _port_bin(scene, tcfg, exact_skip=True)
    assert tb.num_rendered_3sigma == tb3.num_rendered > tb.num_rendered
    ours, jax_skip = _lists(tb, p), _lists(jax_binned, p)
    px, py = TC.pixel_coords(tb.num_tiles, W, tcfg, "cpu")
    conic, opacity = torch.from_numpy(scene[1]), torch.from_numpy(scene[3][:, 0])

    def blends(g, tile):
        return bool(candidate(mean_pix[g], conic[g], opacity[g], px[tile], py[tile]).any())

    for tile in range(tb.num_tiles):
        kept = [g for g in ours3[tile][0] if blends(g, tile)]
        assert [g for g in ours[tile][0] if blends(g, tile)] == kept, tile
        order = iter(ours3[tile][0].tolist())
        assert all(g in order for g in ours[tile][0]), f"tile {tile}: not a subsequence"
        want = [g for g in jax_skip[tile][0] if blends(g, tile)]
        assert set(want) <= set(ours[tile][0]), tile


def test_plain_fwd_matches_pallas(jax_binned, pallas_fwd, tcfg):
    payload, cs, nc = _torch_layout(jax_binned)
    tile_buf = plain_core.raster_fwd_plain(payload, cs, nc, W, H, tcfg)
    np.testing.assert_allclose(tile_buf.numpy(), pallas_fwd, **FWD_TOL)


def test_plain_bwd_matches_pallas(jax_binned, pallas_fwd, jcfg, tcfg):
    rng = np.random.default_rng(3)
    g_img = rng.normal(size=(NCH, H, W)).astype(np.float32)
    g_t = rng.normal(size=(H, W)).astype(np.float32)
    bg = np.array([1, 1, 1, 0, 0, 0, 0, 0, 0, 100], np.float32)
    gbuf = np.array(_disassemble_cotangent(jnp.asarray(g_img), jnp.asarray(g_t),
                                             jnp.asarray(bg), W, H, jcfg))
    gbuf_t = TC.disassemble_cotangent(torch.from_numpy(g_img), torch.from_numpy(g_t),
                                      torch.from_numpy(bg), W, H, tcfg)
    np.testing.assert_allclose(gbuf_t.numpy(), gbuf, rtol=1e-6, atol=1e-5)
    ref = np.asarray(pallas_core.raster_core_pallas_bwd(
        jax_binned, jnp.asarray(pallas_fwd), jnp.asarray(gbuf), W, H, jcfg,
        interpret=True))
    payload, cs, nc = _torch_layout(jax_binned)
    dpay = plain_core.raster_bwd_plain(payload, cs, nc, torch.from_numpy(pallas_fwd),
                                       torch.from_numpy(gbuf), W, H, tcfg)
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(dpay.numpy(), ref, **BWD_TOL)


def _target():
    return np.linspace(0, 1, NCH * H * W, dtype=np.float32).reshape(NCH, H, W)


def _torch_loss_grads(scene, tcfg):
    ndc, conic, colors, opacity, depth, valid, bg = scene
    args = [torch.tensor(x, requires_grad=True) for x in (ndc, conic, colors, opacity)]
    bg_t = torch.tensor(bg, requires_grad=True)
    out = t_rasterize(*args, torch.from_numpy(depth), torch.from_numpy(valid),
                      bg_t, W, H, tcfg)
    loss = torch.sum((out["render"] - torch.from_numpy(_target())) ** 2) \
        + torch.sum(out["final_T"])
    grads = torch.autograd.grad(loss, args + [bg_t])
    return out, [g.numpy() for g in grads]


def test_rasterize_matches_jax_pallas(scene, jcfg, tcfg):
    """``rasterize`` (the exact-skip binning) against the JAX package's
    Pallas path over its 3-sigma binning: forward, radii, the 3-sigma
    instance count and the gradients."""
    ndc, conic, colors, opacity, depth, valid, bg = scene
    cfg = JC.RasterConfig(**{**jcfg.__dict__, "backend": "pallas"})

    def loss(ndc, conic, colors, opacity, bg):
        out = j_rasterize(ndc, conic, colors, opacity, jnp.asarray(depth),
                          jnp.asarray(valid), bg, W, H, cfg)
        return (jnp.sum((out["render"] - jnp.asarray(_target())) ** 2)
                + jnp.sum(out["final_T"]), out)

    with jax_3sigma_binning():
        (_, jout), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *(jnp.asarray(x) for x in (ndc, conic, colors, opacity, bg)))
    out, grads = _torch_loss_grads(scene, tcfg)
    np.testing.assert_allclose(out["render"].detach().numpy(), np.asarray(jout["render"]),
                               **FWD_TOL)
    np.testing.assert_allclose(out["final_T"].detach().numpy(),
                               np.asarray(jout["final_T"]), rtol=5e-4, atol=1e-4)
    np.testing.assert_array_equal(out["radii"].numpy(), np.asarray(jout["radii"]))
    np.testing.assert_array_equal(out["visibility"].numpy(),
                                  np.asarray(jout["visibility"]))
    assert out["num_rendered_3sigma"] == int(jout["num_rendered"]) > out["num_rendered"]
    for a, b, name in zip(grads, jgrads, ["ndc", "conic", "colors", "opacity", "bg"]):
        np.testing.assert_allclose(a, np.asarray(b), **BWD_TOL, err_msg=name)


def test_backward_is_bit_reproducible(scene, tcfg):
    _, g1 = _torch_loss_grads(scene, tcfg)
    _, g2 = _torch_loss_grads(scene, tcfg)
    for a, b in zip(g1, g2):
        np.testing.assert_array_equal(a, b)


def test_plain_probe_matches_tpu_probe_statement(jax_binned, tcfg):
    """The fixed-cost probe's plain version against a numpy statement of
    tools/tpu_profile_r4.py:502-529 (that script cannot run here: it
    profiles at import and calls a stale pallas_core signature): every
    entry of tile t is the sum over t's chunks of payload row 0 summed over
    the lanes; a tile without chunks stays 0.  The CPU wrapper routes to the
    plain version and counts no launch; the grid-only variant has no plain
    version.  Tolerance: float64 plain sums rounded once to float32."""
    from gaussianhaircut_torch.ops.rasterize import cuda_core
    payload, cs, nc = _torch_layout(jax_binned)
    tof = np.asarray(jax_binned.tile_of_chunk)
    kit = np.asarray(jax_binned.chunk_in_tile)
    pay = np.asarray(jax_binned.payload).astype(np.float64)
    nc_empty = nc.clone()
    nc_empty[1] = 0                       # drop one tile's chunks
    for n_chunks in (nc, nc_empty):
        want = np.zeros((jax_binned.num_tiles, tcfg.tile_pix, 16))
        for c in range(len(tof)):
            t = int(tof[c])
            if kit[c] >= 0 and kit[c] < int(n_chunks[t]):
                want[t] += pay[c, 0].sum()
        got = plain_core.raster_probe_plain(payload, cs, n_chunks, tcfg)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    assert (want[1] == 0).all() and (got.numpy()[nc.numpy() > 0] != 0).any()
    before = dict(cuda_core.launches)
    routed = cuda_core.raster_probe(payload, cs, nc, W, H, tcfg)
    np.testing.assert_array_equal(
        routed.numpy(), plain_core.raster_probe_plain(payload, cs, nc, tcfg).numpy())
    assert cuda_core.launches == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_core.raster_probe(payload, cs, nc, W, H, tcfg, grid_only=True)
