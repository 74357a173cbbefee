"""The port's exact-skip binning (``preprocess(..., opacity=)``) composites
exactly the pairs of the reference's 3-sigma tile rect: the rect covers
every tile that holds a pixel within the exact-skip radius, the render and
every gradient equal the 3-sigma binning's, ``num_rendered_3sigma`` counts
what the 3-sigma rect would bin, and the stage-1 step matches the plain
reference under ``benchmark/reference`` with Gaussians placed where
``getRect``'s formula at the fractional radius would drop a tile."""
import math
import os
import sys

import pytest
import torch

from gaussianhaircut_torch.ops.rasterize import common as C
from gaussianhaircut_torch.ops.rasterize.api import (
    ndc_xy_to_pixel, rasterize, rasterize_batched,
)
from tests.exact_skip import candidate

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")


def _get_rect(mean_pix, radius, tile):
    """``getRect``'s tile rect [lo, hi) per axis, [P, 2] each, at a
    fractional radius: it leaves out tile k when p + r falls in
    [k tile, k tile + 1)."""
    r = radius[:, None]
    return (((mean_pix - r) / tile).to(torch.int32).long(),
            ((mean_pix + r + tile - 1) / tile).to(torch.int32).long())


def _capped_bin_radius(radius, opacity):
    """The exact-skip radius capped at 3 sigma, where opacity e^4.5 / 255
    and above would take it past 3 sigma: with ``_get_rect`` the rect that
    the JAX package bins."""
    fac2 = 2.0 * torch.log(torch.clamp(opacity, min=1e-12) * 255.0) / 9.0
    return radius * torch.sqrt(torch.clamp(fac2, 0.0, 1.0))


def _outside(tx, ty, rect, col):
    (lo, hi), shift = rect
    return ((tx < col(lo[:, 0])) | (tx >= col(hi[:, 0])) | (ty < col(lo[:, 1] - shift))
            | (ty >= col(hi[:, 1] - shift)))


def random_gaussians(gen, p, width, height, margin=20.0):
    """Fractional centres in and around the image, anisotropic conics with
    sigmas 0.3-10 px at random angles, opacities log-uniform from 1/255 to
    0.99 (a few at exactly 1/255)."""
    u = lambda *s: torch.rand(*s, generator=gen)
    mean_pix = torch.stack([u(p) * (width + 2 * margin) - margin,
                            u(p) * (height + 2 * margin) - margin], -1)
    sig = torch.exp(u(p, 2) * math.log(10.0 / 0.3)) * 0.3
    th = u(p) * math.pi
    c, s = torch.cos(th), torch.sin(th)
    cxx = c * c * sig[:, 0] ** 2 + s * s * sig[:, 1] ** 2
    cxy = c * s * (sig[:, 0] ** 2 - sig[:, 1] ** 2)
    cyy = s * s * sig[:, 0] ** 2 + c * c * sig[:, 1] ** 2
    det = cxx * cyy - cxy * cxy
    conic = torch.stack([cyy / det, -cxy / det, cxx / det], -1)
    opacity = torch.exp(math.log(1 / 255) + u(p) * math.log(0.99 * 255))[:, None]
    opacity[:8] = 1 / 255
    return mean_pix, conic, opacity


def test_concrete_case_bins_the_edge_tile():
    """sigma 2, opacity 0.1 at (58.962, 20) in a 128x64 image of 32-pixel
    tiles: pixel (64, 20), in x-tile 2, has alpha 0.00419 >= 1/255, so the
    binned rect holds x-tiles [1, 3), as the 3-sigma rect does; getRect's
    formula at the exact-skip radius 5.94 would give [1, 2)."""
    cfg = C.RasterConfig(tile_w=32, tile_h=32, chunk=32)
    mean_pix = torch.tensor([[58.962, 20.0]])
    conic = torch.tensor([[0.25, 0.0, 0.25]])
    opacity = torch.tensor([[0.1]])
    assert candidate(mean_pix[0], conic[0], opacity[0, 0], 64.0, 20.0)
    args = (mean_pix, conic, torch.tensor([5.0]), torch.tensor([True]), 128, 64, cfg)
    pre = C.preprocess(*args, opacity=opacity)
    three = C.preprocess(*args)
    assert [int(v) for v in three.rect] == [1, 0, 3, 1]
    assert [int(v) for v in pre.rect] == [1, 0, 3, 1]
    assert int(pre.tiles_touched[0]) == 2 and int(pre.tiles_3sigma[0]) == 2
    assert int(_get_rect(mean_pix, _capped_bin_radius(pre.radius, opacity[:, 0]), 32)[1][0, 0]) == 2


@pytest.mark.parametrize("row0", [0, 32])
def test_binned_rect_covers_every_candidate_pixel(row0):
    """3,000 seeded random Gaussians, a window of rows [row0, 128) of a
    160x128 image in 16-pixel tiles: every pixel of the 3-sigma rect at
    which the kernels' float32 alpha test passes lies in a binned tile, and
    no binned tile lies outside the 3-sigma rect.  The scene reaches the
    defect: getRect's formula at the capped exact-skip radius leaves out
    tiles that hold such pixels."""
    width, full_h, tile = 160, 128, 16
    height = full_h - row0
    cfg = C.RasterConfig(tile_w=tile, tile_h=tile, chunk=32)
    p = 3000
    mean_pix, conic, opacity = random_gaussians(torch.Generator().manual_seed(1500 + row0),
                                                p, width, full_h)
    args = (mean_pix, conic, torch.full((p,), 5.0), torch.ones(p, dtype=torch.bool),
            width, height, cfg)
    pre = C.preprocess(*args, opacity=opacity, row0=row0)
    three = C.preprocess(*args, row0=row0)
    b0x, b0y, b1x, b1y = pre.rect
    t0x, t0y, t1x, t1y = three.rect
    binned = pre.tiles_touched > 0
    assert (pre.tiles_touched == torch.where(binned, (b1x - b0x) * (b1y - b0y), 0)).all()
    assert ((b0x >= t0x) & (b1x <= t1x) & (b0y >= t0y) & (b1y <= t1y))[binned].all()
    assert torch.equal(pre.tiles_3sigma, three.tiles_touched)
    assert torch.equal(pre.radius, three.radius)
    old = (_get_rect(mean_pix, _capped_bin_radius(pre.radius, opacity[:, 0]), tile),
           row0 // tile)

    ys, xs = torch.meshgrid(torch.arange(row0, full_h, dtype=torch.float32),
                            torch.arange(width, dtype=torch.float32), indexing="ij")
    tx = (xs // tile).long()
    ty = ((ys - row0) // tile).long()
    missed = dropped_by_get_rect = 0
    for s in range(0, p, 250):
        g = slice(s, s + 250)
        cand = candidate(mean_pix[g, None, None], conic[g, None, None],
                         opacity[g, :, None], xs, ys)
        col = lambda v: v[g, None, None]
        in3 = ((tx >= col(t0x)) & (tx < col(t1x)) & (ty >= col(t0y)) & (ty < col(t1y))
               & col(three.tiles_touched > 0))
        inb = ((tx >= col(b0x)) & (tx < col(b1x)) & (ty >= col(b0y)) & (ty < col(b1y))
               & col(binned))
        missed += int((cand & in3 & ~inb).sum())
        dropped_by_get_rect += int((cand & in3 & _outside(tx, ty, old, col)).sum())
    assert missed == 0
    assert dropped_by_get_rect > 0


def _scene(gen, p=400, width=96, height=64):
    mean_pix, conic, opacity = random_gaussians(gen, p, width, height, margin=8.0)
    size = torch.tensor([width, height], dtype=torch.float32)
    ndc = torch.cat([(2.0 * mean_pix + 1.0) / size - 1.0, torch.zeros(p, 1)], -1)
    colors = torch.rand(p, C.NUM_CHANNELS, generator=gen)
    depth = 0.5 + 10.0 * torch.rand(p, generator=gen)
    valid = torch.ones(p, dtype=torch.bool)
    bg = torch.tensor([1, 1, 1, 0, 0, 0, 0, 0, 0, 100], dtype=torch.float32)
    return ndc, conic, colors, opacity, depth, valid, bg


def _render_and_grads(scene, width, height, cfg, weight):
    ndc, conic, colors, opacity, depth, valid, bg = scene
    leaves = [x.clone().requires_grad_(True) for x in (ndc, conic, colors, opacity, bg)]
    out = rasterize(leaves[0], leaves[1], leaves[2], leaves[3], depth, valid, leaves[4],
                    width, height, cfg)
    loss = torch.sum(out["render"] * weight) + torch.sum(out["final_T"] * weight[0])
    return out, torch.autograd.grad(loss, leaves)


def test_exact_skip_composites_the_3sigma_pairs(monkeypatch):
    """On a seeded scene that reaches the defect (two views of it, 16- and
    32-pixel tiles), the render, the final transmittance, the radii and
    every gradient of ``rasterize`` equal the 3-sigma binning's bit for bit
    on the CPU, with fewer instances.  Bit for bit because the dropped
    instances pass the alpha test at no pixel of their tile: both kernels
    walk the same candidate pairs in the same depth order, a dropped
    instance's gradient row would be zero, and the sequential float64 scan
    of the segment reduction adds nothing for it (on the card the scan is a
    parallel one, whose association follows the stream's length)."""
    width, height = 96, 64
    weight = torch.randn(C.NUM_CHANNELS, height, width,
                         generator=torch.Generator().manual_seed(2))
    preprocess = C.preprocess
    for seed, tile in ((4, 16), (8, 32)):
        cfg = C.RasterConfig(tile_w=tile, tile_h=tile, chunk=32)
        scene = _scene(torch.Generator().manual_seed(seed), width=width, height=height)
        got, got_g = _render_and_grads(scene, width, height, cfg, weight)
        with monkeypatch.context() as m:
            m.setattr(C, "preprocess", lambda *a, opacity=None, **k: preprocess(*a, **k))
            ref, ref_g = _render_and_grads(scene, width, height, cfg, weight)
        for k in ("render", "final_T", "radii", "visibility"):
            assert torch.equal(got[k], ref[k]), (seed, k)
        for a, b, name in zip(got_g, ref_g, ("ndc", "conic", "colors", "opacity", "bg")):
            assert b.abs().max() > 0, name
            assert torch.equal(a, b), (seed, name)
        assert got["num_rendered"] < ref["num_rendered"] == got["num_rendered_3sigma"]
        # the scene reaches the defect: getRect's formula would drop pairs
        ndc, conic, _, opacity, *_ = scene
        mean_pix = ndc_xy_to_pixel(ndc, width, height)
        pre = C.preprocess(mean_pix, conic, scene[4], scene[5], width, height, cfg)
        old = (_get_rect(mean_pix, _capped_bin_radius(pre.radius, opacity[:, 0]), tile), 0)
        ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                                torch.arange(width, dtype=torch.float32), indexing="ij")
        cand = candidate(mean_pix[:, None, None], conic[:, None, None], opacity[:, :, None],
                         xs, ys)
        tx, ty = (xs // tile).long(), (ys // tile).long()
        col = lambda v: v[:, None, None]
        in3 = ((tx >= col(pre.rect[0])) & (tx < col(pre.rect[2])) & (ty >= col(pre.rect[1]))
               & (ty < col(pre.rect[3])) & col(pre.tiles_touched > 0))
        assert (cand & in3 & _outside(tx, ty, old, col)).any(), seed


def test_num_rendered_3sigma_counts_the_3sigma_rect():
    """``num_rendered_3sigma`` is the 3-sigma rect's tile count summed
    (``preprocess`` without ``opacity``), at least ``num_rendered``; over a
    batch of two cameras it is the sum of both."""
    width, height = 96, 64
    cfg = C.RasterConfig(tile_w=16, tile_h=16, chunk=32)
    scenes = [_scene(torch.Generator().manual_seed(s), width=width, height=height)
              for s in (5, 6)]
    counts = []
    for ndc, conic, colors, opacity, depth, valid, bg in scenes:
        out = rasterize(ndc, conic, colors, opacity, depth, valid, bg, width, height, cfg)
        pre = C.preprocess(ndc_xy_to_pixel(ndc, width, height), conic, depth, valid,
                           width, height, cfg)
        assert out["num_rendered_3sigma"] == int(pre.tiles_touched.sum())
        assert out["num_rendered_3sigma"] > out["num_rendered"] > 0
        counts.append((out["num_rendered"], out["num_rendered_3sigma"]))
    stacked = [torch.stack(x) for x in zip(*scenes)]
    out = rasterize_batched(*stacked[:6], scenes[0][6], width, height, cfg)
    assert out["num_rendered"] == sum(n for n, _ in counts)
    assert out["num_rendered_3sigma"] == sum(n for _, n in counts)


# --------------------------------------------- stage 1 against the reference --

def _bench_path():
    if BENCH not in sys.path:
        sys.path.append(BENCH)


def _plant(driver, idx, per_axis=4):
    """Set the opacity of ``per_axis`` Gaussians per axis, visible in view
    ``idx``, so that a pixel of tile k, the tile past the centre, passes the
    alpha test while the exact-skip radius r_b stays under k tile + 1 - p:
    getRect's formula at r_b would leave out tile k.  Returns the rows and
    the view's instance count over the 3-sigma rect."""
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.render.renderer import fields_from_params, prepare_raster_inputs
    from gaussianhaircut_torch.scene.cameras import CameraResiduals, camera_geom
    cfg, cams, init = driver.cfg, driver.cams, driver.init
    w, h, tile = cfg["width"], cfg["height"], cfg["tile"]
    n = init["xyz"].shape[0]
    alive = torch.ones(n, dtype=torch.bool)
    cam = camera_geom(cams["colmap_transform"][idx], cams["fovx"][idx], cams["fovy"][idx], w, h,
                      CameraResiduals.create(cfg["views"], True, "cpu"), idx)
    with torch.no_grad():
        ndc, conic, _, _, depth, valid = prepare_raster_inputs(
            fields_from_params(gm.GaussianParams(**init), alive), cfg["active_sh_degree"], cam)
    mean_pix = ndc_xy_to_pixel(ndc, w, h).double()
    rcfg = C.RasterConfig(tile_w=tile, tile_h=tile)
    pre = C.preprocess(mean_pix.float(), conic, depth, valid, w, h, rcfg)
    conic = conic.double()
    size = (w, h)
    rows, taken = [], set()
    for axis in (0, 1):
        placed = 0
        for g in torch.argsort(depth).tolist():
            if placed == per_axis:
                break
            r3 = float(pre.radius[g])
            if g in taken or r3 <= 0 or not bool(pre.valid[g]):
                continue
            p = mean_pix[g]
            k = math.floor(float(p[axis]) / tile) + 1
            other = round(float(p[1 - axis]))
            d = k * tile - float(p[axis])
            if k * tile >= size[axis] or not 0 <= other < size[1 - axis] or d + 1 > r3:
                continue
            dx, dy = (d, other - float(p[1])) if axis == 0 else (other - float(p[0]), d)
            a, b, c = conic[g].tolist()
            q = a * dx * dx + 2 * b * dx * dy + c * dy * dy
            hi = min(9.0 * (d + 1) ** 2 / r3 ** 2, 9.0)
            if hi - q < 0.5:
                continue
            two_l = q + 0.8 * (hi - q)          # q < 2 ln(255 op) < hi
            op = math.exp(two_l / 2) / 255.0
            init["opacity"][g] = math.log(op / (1.0 - op))
            rows.append(g)
            taken.add(g)
            placed += 1
        assert placed == per_axis, (axis, placed)
    return rows, int(pre.tiles_touched.sum())


def test_stage1_step_matches_reference_with_planted_edges(monkeypatch):
    """The benchmark's tiny stage-1 cell (64x48, 16x16 tiles, 300 Gaussians)
    with 8 Gaussians planted on tile edges (``_plant``): the port's step
    (the exact-skip path) against the plain reference, which bins the
    3-sigma rect, within the tiny cell's limits of the loss, every leaf's
    gradient and the change; and the planted Gaussians' own first-step
    gradient rows, every leaf, within 1e-4 of the reference's norm over
    those rows: the tiny limits are too coarse to see a few dropped pairs
    (a port that drops the planted Gaussians' edge tiles passes them), but
    those rows are then 4e-3 to 3.5e-2 off, where the exact path reads
    2.2e-6 at most.
    The steps report ``num_rendered_3sigma``, the 3-sigma rect's count."""
    _bench_path()
    from benchlib import compare, registry
    from reference import stage1 as ref
    from tinycells import tiny

    from gaussianhaircut_torch.train import stage1

    cell = tiny("head_3dgs.s1_1m")
    d = registry.driver(cell.driver)(cell.config, cell.traffic, 11, "cpu")
    first = d.order.peek()
    rows, count_3sigma = _plant(d, first)
    seen = {}

    def port_step(state, *a, **k):
        new, m = real_port(state, *a, **k)
        seen.setdefault("port", (new, m))
        return new, m

    def ref_step(state, *a, **k):
        new = real_ref(state, *a, **k)
        seen.setdefault("ref", new[0])
        return new

    real_port, real_ref = stage1.train_step, ref.step
    monkeypatch.setattr(stage1, "train_step", port_step)
    monkeypatch.setattr(ref, "step", ref_step)
    d.start()
    d.free()
    nums = compare.numbers(d.program_readings, d.reference_readings(), cell.loss_steps)
    assert compare.verdict(nums, cell.limits), nums

    port_state, metrics = seen["port"]
    worst = {}
    for name in ref.PARAMS:
        if name == "viewspace":
            continue
        got = getattr(port_state.opt.mu, name)[rows]
        want = seen["ref"]["mu"][name][rows]
        worst[name] = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert max(worst.values()) < 1e-4, worst
    assert metrics["num_rendered_3sigma"] == count_3sigma > metrics["num_rendered"] > 0
