"""The kernels' exact per-warp cull (``csrc/raster_common.cuh: warp_mask``)
through its plain mirror ``plain_core.warp_masks_plain``, and the tiles'
heavy-first order.

The cull may only drop (warp, instance) pairs in which no pixel is a
candidate of the kernels' float test: power <= 0 (in the forward also a NaN
power) and min(0.99, op exp(power)) >= 1/255.  Every such pair is checked
here, not only those a pixel visits before it stops, on seeded payloads
holding the edge cases: op at 1/255, near-singular conics, non-finite
geometry, splats on warp and tile edges and very large splats."""
import numpy as np
import pytest
import torch

from gaussianhaircut_torch import kernels
from gaussianhaircut_torch.ops.rasterize import common as C
from gaussianhaircut_torch.ops.rasterize import cuda_core, plain_core

F32 = np.float32
ALPHA_MIN = plain_core.ALPHA_MIN_F32


def _layout(cols: np.ndarray, num_tiles: int, ch: int):
    """Instance columns [N, 6] (gx, gy, a, b, c, op) dealt round-robin into
    every tile's chunks -> (payload [TC, 24, CH], chunk_start, nchunks).
    Tile t owns t % 3 + 1 chunks; one more chunk at the end is in no
    tile's range."""
    nchunks = np.array([t % 3 + 1 for t in range(num_tiles)], np.int32)
    chunk_start = (np.cumsum(nchunks) - nchunks).astype(np.int32)
    tc = int(nchunks.sum()) + 1
    payload = np.zeros((tc, C.PAYLOAD_ROWS, ch), F32)
    reps = np.resize(np.arange(len(cols)), tc * ch)
    payload[:, :6, :] = cols[reps].reshape(tc, ch, 6).transpose(0, 2, 1)
    payload[:, C.F_VALID] = 1.0
    return (torch.from_numpy(payload), torch.from_numpy(chunk_start),
            torch.from_numpy(nchunks))


def _candidates(payload, chunk_start, nchunks, width, cfg):
    """[TC, PIX, CH] bool: the pairs the kernels' float test accepts, with
    the forward's NaN semantics (fminf(0.99, NaN) = 0.99) and the
    backward's (NaN power is skipped) both counted."""
    num_tiles = chunk_start.shape[0]
    px, py = C.pixel_coords(num_tiles, width, cfg, "cpu")
    out = torch.zeros((payload.shape[0], cfg.tile_pix, payload.shape[2]), dtype=torch.bool)
    for t in range(num_tiles):
        for k in range(int(nchunks[t])):
            c = int(chunk_start[t]) + k
            g = payload[c, :6, None, :]                          # [6, 1, CH]
            dx = g[C.F_GX] - px[t][:, None]
            dy = g[C.F_GY] - py[t][:, None]
            a, b, cc, op = g[C.F_CA], g[C.F_CB], g[C.F_CC], g[C.F_OP]
            power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
            raw = op * torch.exp(power)
            alpha = torch.where(torch.isnan(raw), torch.full_like(raw, 0.99),
                                torch.clamp(raw, max=0.99))
            out[c] = ~(power > 0.0) & (alpha >= ALPHA_MIN)
    return out


def _covered(masks, cand, cfg):
    """Whether every candidate pair's warp bit is set."""
    bit = (masks[:, None, :] >> plain_core.warp_of_pixel(cfg)[None, :, None]) & 1
    return bool((bit.bool() | ~cand).all()), int(cand.sum())


def _conic(s1, s2, theta):
    c, s = np.cos(theta), np.sin(theta)
    cov = np.array([[c * c * s1 + s * s * s2, c * s * (s1 - s2)],
                    [c * s * (s1 - s2), s * s * s1 + c * c * s2]])
    inv = np.linalg.inv(cov)
    return inv[0, 0], inv[0, 1], inv[1, 1]


def _edge_cases(rng, width, height, cfg):
    """Instance columns for the cases the cull must survive."""
    cols = []
    # random splats over and around the image, sigma 0.3 .. 20 px
    for _ in range(120):
        a, b, c = _conic(rng.uniform(0.1, 400), rng.uniform(0.1, 400), rng.uniform(0, np.pi))
        cols.append([rng.uniform(-20, width + 20), rng.uniform(-20, height + 20),
                     a, b, c, rng.uniform(0.0, 1.0)])
    one_over = float(F32(ALPHA_MIN))
    for op in (np.nextafter(F32(one_over), F32(1)), F32(one_over),
               np.nextafter(F32(one_over), F32(0)), F32(0.0), F32(-0.5), F32(0.0039)):
        cols.append([width / 2 + 0.3, height / 2 - 0.2, 0.5, 0.1, 0.5, op])
    # splats centred on warp and tile edges, small enough that the box ends
    # next to a block boundary
    for x in (7.5, 8.0, 8.5, 15.999, 16.0, cfg.tile_w - 0.5, cfg.tile_w + 0.5,
              cfg.tile_w * 1.0):
        for y in (3.5, 4.0, 4.001, cfg.tile_h - 0.5, cfg.tile_h * 1.0):
            for s in (0.05, 0.6, 1.7):
                cols.append([x, y, 1.0 / s, 0.0, 1.0 / s, 0.99])
    # near-singular and singular conics (elongated up to and past the
    # conditioning limit), not positive definite
    for ratio in (1e2, 1e4, 2.0 ** 19, 2.0 ** 21, 1e9):
        for theta in (0.0, 0.3, np.pi / 4, 1.2):
            a, b, c = _conic(ratio * 0.3, 0.3, theta)
            cols.append([width * 0.4, height * 0.6, a, b, c, 0.9])
    for a, b, c in ((1.0, 1.0, 1.0), (1.0, 1.0000001, 1.0), (1.0, 0.99999994, 1.0),
                    (-1.0, 0.0, -1.0), (1.0, 0.0, -1.0), (0.0, 0.0, 0.0),
                    (4.0, 1.9999999, 1.0)):
        cols.append([width * 0.5, height * 0.5, a, b, c, 0.8])
    # non-finite and out-of-range values
    nan, inf = float("nan"), float("inf")
    for bad in ([nan, 5, 1, 0, 1, 0.5], [5, inf, 1, 0, 1, 0.5], [5, 5, nan, 0, 1, 0.5],
                [5, 5, 1, inf, 1, 0.5], [5, 5, 1, 0, 1, nan], [5, 5, 1, 0, 1, inf],
                [5, 5, 1, 0, 1e30, 0.5], [3e6, 5, 1, 0, 1, 0.5], [5, 5, 1e20, 0, 1e20, 1e-3],
                # finite, but the power overflows to -inf + inf = NaN, which
                # the forward blends
                [10.5, 10.5, 1e38, -0.9e38, 1e38, 0.9]):
        cols.append(bad)
    # very large splats: sigma 1e3 .. 1e5 px, and tiny conic entries
    for s in (1e3, 1e5):
        cols.append([-50.0, height + 70.0, 1.0 / s ** 2, 0.0, 1.0 / s ** 2, 0.7])
    cols.append([width / 2, height / 2, 1e-30, 0.0, 1e-30, 1.0])
    return np.asarray(cols, F32)


@pytest.mark.parametrize("tile,chunk", [(32, 64), (16, 32), (8, 32)])
def test_cull_is_conservative(tile, chunk):
    """Every candidate pair lies in a warp whose bit is set, for the bench
    tile (32x32: 32 warps, bit 31 used) and smaller tiles; the mask still
    drops most (warp, instance) pairs of small splats."""
    cfg = C.RasterConfig(tile_w=tile, tile_h=tile, chunk=chunk)
    width, height = 2 * tile + 8, 2 * tile
    num_tiles = int(np.prod(cfg.grid(width, height)))
    rng = np.random.default_rng(tile)
    lay = _layout(_edge_cases(rng, width, height, cfg), num_tiles, chunk)
    masks = plain_core.warp_masks_plain(*lay, width, cfg)
    cand = _candidates(*lay, width, cfg)
    ok, n_cand = _covered(masks, cand, cfg)
    assert ok
    assert n_cand > 1000
    nw = (tile // 8) * (tile // 4)
    assert int(masks.max()) <= (1 << nw) - 1
    used = torch.zeros(masks.shape[0], dtype=torch.bool)
    for t in range(num_tiles):
        used[int(lay[1][t]):int(lay[1][t]) + int(lay[2][t])] = True
    bits = sum(((masks[used] >> w) & 1).sum() for w in range(nw))
    if nw > 2:
        assert int(bits) < 0.6 * int(used.sum()) * chunk * nw
    # the chunk in no tile's range stays 0
    assert (~used).sum() == 1 and (masks[~used] == 0).all()


def test_cull_is_conservative_on_strand_splats():
    """The stage-2/3 hair Gaussians: opacity 1, a cross-section of
    sigma^2 = r^2 + 0.3 px^2 (r ~ 0.4 px: strand_scale 1e-3 seen from 2.5
    units) and a long axis of half a segment, 0 to 30 px, at every angle,
    crowded into one tile: every candidate pair is covered, and the boxes
    of such thin splats still drop most (warp, instance) pairs."""
    cfg = C.RasterConfig(tile_w=32, tile_h=32, chunk=64)
    width, height = 72, 64
    num_tiles = int(np.prod(cfg.grid(width, height)))
    rng = np.random.default_rng(4)
    cols = []
    for _ in range(400):
        half_len = rng.choice([0.0, rng.uniform(0.0, 3.0), rng.uniform(3.0, 30.0)])
        a, b, c = _conic(half_len ** 2 + 0.3, rng.uniform(0.0, 0.3) + 0.3, rng.uniform(0, np.pi))
        cols.append([rng.uniform(-4, width + 4), rng.uniform(-4, height + 4), a, b, c, 1.0])
    lay = _layout(np.asarray(cols, F32), num_tiles, cfg.chunk)
    masks = plain_core.warp_masks_plain(*lay, width, cfg)
    cand = _candidates(*lay, width, cfg)
    ok, n_cand = _covered(masks, cand, cfg)
    assert ok and n_cand > 1000
    kept = sum(int(((masks >> w) & 1).sum()) for w in range(32))
    assert kept < 0.25 * int(lay[2].sum()) * cfg.chunk * 32


def test_cull_edge_values():
    """op below 1/255 culls everywhere; non-finite, out-of-range,
    non-positive-definite and ill-conditioned geometry is never culled."""
    cfg = C.RasterConfig(tile_w=32, tile_h=32, chunk=32)
    one_over = F32(ALPHA_MIN)
    cols = np.asarray([
        [10, 10, 0.5, 0, 0.5, np.nextafter(one_over, F32(0))],    # faint: 0
        [10, 10, 0.5, 0, 0.5, 0.0],                               # empty slot: 0
        [10, 10, 0.5, 0, 0.5, np.nextafter(one_over, F32(1))],    # tiny box
        [float("nan"), 10, 0.5, 0, 0.5, 0.0],                     # NaN: all
        [10, 10, 0.5, 0, 0.5, float("inf")],                      # inf op: all
        [10, 10, 1.0, 1.0, 1.0, 0.9],                             # singular: all
        [10, 10, -1.0, 0.0, 1.0, 0.9],                            # indefinite: all
        [10, 10, 1.0, 0.0, 2.0 ** 22, 0.9],                       # K > 2^20: all
        [2.0 ** 21, 10, 1.0, 0.0, 1.0, 0.9],                      # far: all
    ] + [[0, 0, 0, 0, 0, 0]] * 23, F32)
    payload, cs, nc = _layout(cols, 1, 32)
    nc[0] = 1
    m = plain_core.warp_masks_plain(payload, cs, nc, 32, cfg)[0].tolist()
    full = (1 << 32) - 1
    assert m[:9] == [0, 0, m[2], full, full, full, full, full, full]
    # the tiny box around (10, 10) meets only the warp holding that pixel
    assert m[2] == 1 << int(plain_core.warp_of_pixel(cfg)[10 * 32 + 10])
    # the CPU route of the card's mask wrapper is the plain mirror
    before = dict(kernels.launches)
    np.testing.assert_array_equal(cuda_core.warp_masks(payload, cs, nc, 32, 32, cfg),
                                  plain_core.warp_masks_plain(payload, cs, nc, 32, cfg))
    assert kernels.launches == before


def test_warp_footprints():
    """Warp w owns the 8x4 block (w % (tile_w / 8), w / (tile_w / 8)): each
    warp holds 32 pixels of one block."""
    cfg = C.RasterConfig(tile_w=32, tile_h=16, chunk=32)
    w = plain_core.warp_of_pixel(cfg).reshape(16, 32)
    assert torch.bincount(w.flatten()).tolist() == [32] * 16
    assert (w[:4, :8] == 0).all() and (w[:4, 24:] == 3).all() and (w[12:, 24:] == 15).all()


def test_tile_order_is_heavy_first():
    """heavy_first is a permutation of the tiles with descending chunk
    counts (ties by tile index); on a binned layout its first tile holds
    the most chunks."""
    rng = np.random.default_rng(5)
    nchunks = torch.from_numpy(rng.integers(1, 30, 511).astype(np.int32))
    order = cuda_core.heavy_first(nchunks)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(511))
    counts = nchunks[order.long()]
    assert (counts[:-1] >= counts[1:]).all()
    ties = (counts[:-1] == counts[1:])
    assert (order[:-1][ties] < order[1:][ties]).all()

    p, width, height = 300, 64, 48
    cfg = C.RasterConfig(tile_w=16, tile_h=16, chunk=32)
    mean = torch.from_numpy(rng.uniform(0, [width, height], (p, 2)).astype(F32))
    s = rng.uniform(1.0, 60.0, p).astype(F32)
    conic = torch.from_numpy(np.stack([1 / s, np.zeros_like(s), 1 / s], -1))
    opacity = torch.from_numpy(rng.uniform(0.1, 1.0, (p, 1)).astype(F32))
    depth = torch.from_numpy(rng.uniform(1.0, 5.0, p).astype(F32))
    pre = C.preprocess(mean, conic, depth, torch.ones(p, dtype=torch.bool), width,
                       height, cfg, opacity=opacity)
    b = C.bin_instances(pre, mean, conic, opacity, torch.zeros(p, 10), depth,
                        width, height, cfg)
    order = cuda_core.heavy_first(b.nchunks)
    assert int(b.nchunks[int(order[0])]) == int(b.nchunks.max()) > int(b.nchunks.min())
    assert int(b.nchunks[int(order[-1])]) == int(b.nchunks.min())


def test_plain_walk_counts_kept_pairs():
    """The plain forward's ``kept`` count (the visited pairs the kernels
    evaluate, which the bound in chip_smoke.py counts): all visited pairs
    under full masks, none under empty ones, and under the cull's masks
    between the blended and the visited pairs, fewer than all."""
    cfg = C.RasterConfig(tile_w=16, tile_h=16, chunk=32)
    width, height = 40, 32
    num_tiles = int(np.prod(cfg.grid(width, height)))
    lay = _layout(_edge_cases(np.random.default_rng(3), width, height, cfg)[:150],
                  num_tiles, cfg.chunk)
    lay[0][:, 8:8 + C.NUM_CHANNELS] = 0.5
    masks = plain_core.warp_masks_plain(*lay, width, cfg)
    counts = {}
    for name, m in (("full", torch.full_like(masks, (1 << 8) - 1)),
                    ("empty", torch.zeros_like(masks)), ("cull", masks)):
        stats = {}
        buf = plain_core.raster_fwd_plain(*lay, width, height, cfg, stats=stats, masks=m)
        counts[name] = stats
        torch.testing.assert_close(buf, plain_core.raster_fwd_plain(*lay, width, height, cfg),
                                   rtol=0, atol=0)
    assert counts["full"]["kept"] == counts["full"]["visited"]
    assert counts["empty"]["kept"] == 0
    cull = counts["cull"]
    assert cull["contrib"] > 0
    assert cull["contrib"] <= cull["kept"] < cull["visited"]
    stats = {}
    plain_core.raster_fwd_plain(*lay, width, height, cfg, stats=stats)
    assert "kept" not in stats and stats["visited"] == cull["visited"]
