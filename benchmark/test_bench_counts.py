"""The counts behind the rooflines and ``step_mfu``, against hand counts on
a tiny layout and against PyTorch's own FLOP counter."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchlib import counts, peaks
from benchlib.runner import Record
from reference import raster
from reference import strands as S

PEAK = peaks.PEAKS["NVIDIA H100 80GB HBM3"]


def layout():
    """Five Gaussians over one 16x16 tile, front to back:
    A  broad, opacity 0.5: every pixel blends it (T ~0.5 after);
    B  sharp at (3, 3), conic 2, opacity 0.9: alpha >= 1/255 where
       dx^2 + dy^2 <= ln(229.5) = 5.44, 21 pixels;
    C  broad, alpha clamped to 0.99: every pixel blends it (T ~0.005 after);
    D  the same: T would fall below 1e-4, so every pixel stops at it;
    E  the same, after every pixel has stopped.
    Blended pairs: 256 + 21 + 256 = 533, by 3 Gaussians."""
    mean = torch.tensor([[8.0, 8.0], [3.0, 3.0], [12.0, 12.0], [5.0, 5.0], [9.0, 2.0]])
    conic = torch.tensor([[1e-4, 0.0, 1e-4], [2.0, 0.0, 2.0]] + [[1e-6, 0.0, 1e-6]] * 3)
    opacity = torch.tensor([0.5, 0.9, 0.999, 0.999, 0.999])
    depth = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    cov = torch.stack([conic[:, 2], -conic[:, 1], conic[:, 0]], -1) / (
        conic[:, 0] * conic[:, 2] - conic[:, 1] ** 2)[:, None]
    colours = torch.rand((5, 10), generator=torch.Generator().manual_seed(0))
    return mean, conic, opacity, depth, cov, colours


def test_blended_pairs_hand_count():
    mean, conic, opacity, depth, cov, colours = layout()
    binning = raster.bin_gaussians(mean, cov, depth, torch.ones(5, dtype=torch.bool), 16, 16, 16)
    assert raster.count_pairs(mean, conic, opacity, colours, binning, 16) == (533, 3)


def test_blended_pairs_match_the_ports_plain_count():
    """The port's plain compositing counts the same blended pairs."""
    from gaussianhaircut_torch.ops.rasterize import common as C
    from gaussianhaircut_torch.ops.rasterize import plain_core
    mean, conic, opacity, depth, _, colours = layout()
    cfg = C.RasterConfig(tile_w=16, tile_h=16, chunk=32)
    valid = torch.ones(5, dtype=torch.bool)
    pre = C.preprocess(mean, conic, depth, valid, 16, 16, cfg, opacity=opacity[:, None])
    b = C.bin_instances(pre, mean, conic, opacity[:, None], colours, depth, 16, 16, cfg)
    stats = {}
    plain_core.raster_fwd_plain(b.payload, b.chunk_start, b.nchunks, 16, 16, cfg, stats=stats)
    assert stats["contrib"] == 533


def test_kernel_operations_and_bytes():
    work = {"pairs": 533, "gaussians_blended": 3, "pixels": 256}
    assert counts.raster_fwd(work) == (533 * 40, 4 * (3 * 16 + 256 * 11))
    assert counts.raster_bwd(work) == (533 * 90, 4 * (2 * 3 * 16 + 256 * 12))
    t, by = counts.bound_s(*counts.raster_fwd(work), PEAK)
    assert by == "bytes" and t == pytest.approx(4 * (48 + 256 * 11) / 3.35e12)
    assert counts.bound_s(67e12, 1.0, PEAK) == (1.0, "operations")


def test_unet_count_by_hand_and_by_torch():
    cfg = {"input_channels": 4, "input_size": 4, "mapping_out": 8, "depths": [1],
           "channels": [8], "sigma_data": 0.5}
    # map 256 + 128; block 4->8: cond 256, convs 9216 + 18432, skip 1024;
    # block 8->8: cond 256, convs 18432 + 18432; out conv 9216
    assert counts.unet(cfg) == 75648
    for cfg in (cfg, {"input_channels": 64, "input_size": 32, "mapping_out": 256,
                      "depths": [2, 4, 4], "channels": [128, 256, 512], "sigma_data": 0.5}):
        w = {k: torch.zeros(shape) for k, shape, _ in S.unet_specs("net", cfg)}
        x = torch.zeros((1, cfg["input_size"], cfg["input_size"], cfg["input_channels"]))
        with FlopCounterMode(display=False) as fc:
            S.unet(w, "net", x, torch.ones(1), cfg)
        assert counts.unet(cfg) == fc.get_total_flops()


def test_decoders_count_by_torch():
    w = {k: torch.zeros(shape) for k, shape, _ in
         S.decoder_specs("decoder", 100) + S.colour_specs("color_decoder", 3)}
    z = torch.zeros((50, 64))
    with FlopCounterMode(display=False) as fc:
        S.decode_segments(w, z, 100)
    assert counts.strand_decoder(50, 100) == fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        S.decode_colour(w, z)
    assert counts.colour_decoder(50, 3) == fc.get_total_flops()


def test_roofline_and_mfu_readers():
    from benchlib import registry
    rec = Record(traced={
        "d": [{"kernel_s": {"raster_fwd_kernel": 1e-3, "raster_bwd_kernel": 4e-3}, "busy_s": 0.02}],
        "work": [{"raster_fwd": (6.7e9, 1.0), "raster_bwd": (1.0, 3.35e9), "step_ops": 6.7e11}]})
    assert registry.reader("raster_fwd_roofline.s1")(rec, PEAK) == pytest.approx(10.0)
    assert registry.reader("raster_bwd_roofline.s1")(rec, PEAK) == pytest.approx(25.0)
    assert registry.reader("step_mfu.s1")(rec, PEAK) == pytest.approx(50.0)
    # nothing to read, or no peak for the card: no number, never 0
    assert registry.reader("raster_fwd_roofline.s1")(Record(), PEAK) is None
    assert registry.reader("step_mfu.s1")(rec, None) is None
    assert not math.isnan(counts.unet({"input_channels": 1, "input_size": 2, "mapping_out": 1,
                                       "depths": [1], "channels": [1]}))
