"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
benchmark's own tests: the same configurations and drivers, with four 64x48
views, 16x16 tiles, 300 Gaussians, 16 strands of 8 points and a two-level
UNet of 32 and 64 channels.

Their limits are their own, set as the cells' are, from readings at this
size on the CPU (``calibrate.calibrate`` over seeds 1-10, the control and
the planted faults on seeds 1-3): with a few hundred pixels and Gaussians,
one dropped or added pair moves the numbers more than at full size.
Largest sound reading / smallest failing reading -> limit:

- head_3dgs: loss 1.2e-5 / 1.35e-4 (control) -> 4e-5; grad 2.3e-3 / 0.31
  (altered tile) -> 0.05; change 2.5e-3 / 0.083 (half batch) -> 0.02;
- strands_10k: loss (first step) 4.2e-5 / 3.4e-3 (altered tile) -> 5e-4;
  grad 2.7e-6 / 0.026 (control) -> 1e-4; change 1.6e-4 / 0.013 (control)
  -> 2e-3.
"""
from __future__ import annotations

import copy
import os

from benchlib import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMITS = {"head_3dgs.s1_1m": {"loss_gap": 4e-5, "grad_gap": 0.05, "change_gap": 0.02},
          "strands_10k.s2_diffusion": {"loss_gap": 5e-4, "grad_gap": 1e-4, "change_gap": 2e-3}}


def tiny(name: str) -> registry.Cell:
    cell = registry.cell(ROOT, registry.load_benchmark(ROOT, pending=True), name)
    c = copy.deepcopy(cell.config)
    c.update(views=4, width=64, height=48, tile=16, chunk=32)
    # 300 Gaussians are a fresh job's density, not the late phase that the
    # densification cap stands for: they keep their 3-NN scales
    c.get("gaussians", {}).pop("max_scale", None)
    if "num_strands" in c:
        c.update(num_strands=16, strand_length=8, pool_size=500, texture_size=16,
                 diffusion_input=8)
        c["unet"].update(input_size=8, depths=[1, 1], channels=[32, 64])
        c["head"]["count"] = 300
    traffic = dict(cell.traffic, gaussians=300, warmup_steps=1, trace_steps=2, gap_steps=1,
                   roofline_steps=1)
    return registry.Cell(cell.name, c, traffic, cell.driver, cell.chips, LIMITS[name],
                         cell.end_to_end, cell.per_layer, cell.loss_steps)
