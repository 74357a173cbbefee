"""The reference against the port's plain path at a tiny size on the CPU: a
whole run of each cell passes its comparison, the reference's render is the
port's, and the comparison's control and the planted faults fail it."""
import pytest
import torch

import faults
from benchlib import compare, registry, runner
from reference import geometry as geo
from reference import precision
from reference.render import render
from reference.stage1 import fields
from tinycells import ROOT, tiny

CELLS = ("head_3dgs.s1_1m", "strands_10k.s2_diffusion")


def _run(name, seed=3, trace=False):
    return runner.run(ROOT, name, seed, 0.5, trace, 0.0, device="cpu", require_chip=False,
                      cell_override=tiny(name))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, correct = _run(name)
    assert correct, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_reference_render_is_the_ports(monkeypatch):
    """The port's plain render, with its binning's 3-sigma tile rect (the
    reference's), equals the reference's.  The timed path shrinks the rect
    to an 'exact-skip' radius, which drops a few blended pairs at tile
    edges: that difference is the comparison's to judge."""
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.ops.rasterize import api, common
    from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
    from gaussianhaircut_torch.render.renderer import render as port_render
    from gaussianhaircut_torch.scene.cameras import CameraResiduals, camera_geom
    cell = tiny("head_3dgs.s1_1m")
    d = registry.driver(cell.driver)(cell.config, cell.traffic, 5, "cpu")
    cfg, cams = cell.config, d.cams
    alive = torch.ones(d.init["xyz"].shape[0], dtype=torch.bool)
    ours = render(fields(d.init, alive), 3,
                  geo.camera(cams["colmap_transform"][1], cams["fovx"][1], cams["fovy"][1],
                             cfg["width"], cfg["height"]),
                  torch.tensor([0.0] * 9 + [100.0]), cfg["tile"])
    params = gm.GaussianParams(**d.init)
    preprocess = common.preprocess
    monkeypatch.setattr(api.C, "preprocess",
                        lambda *a, opacity=None, **k: preprocess(*a, **k))
    cam = camera_geom(cams["colmap_transform"][1], cams["fovx"][1], cams["fovy"][1],
                      cfg["width"], cfg["height"], CameraResiduals.create(4, True, "cpu"), 1)
    theirs = port_render(params, alive, 3, cam, torch.tensor([0.0] * 9 + [100.0]),
                         RasterConfig(tile_w=16, tile_h=16, chunk=32))
    for key in ("render", "mask", "orient_conf", "final_T"):
        torch.testing.assert_close(ours[key], theirs[key], rtol=1e-5, atol=1e-5)
    assert ours["instances"] == theirs["num_rendered"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference at TF32 in the port's place comes out not correct."""
    cell = tiny(name)
    for seed in (1, 2, 3):
        d = registry.driver(cell.driver)(cell.config, cell.traffic, seed, "cpu")
        d.start()
        d.free()
        ref = d.reference_readings()
        with precision.mode("tf32"):
            nums = compare.numbers(d.reference_readings(), ref, cell.loss_steps)
        assert not compare.verdict(nums, cell.limits), (seed, nums)


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_step_is_not_correct(name, fault):
    """A whole run, the chip's look skipped, with the port's step broken."""
    with faults.planted(fault):
        result, correct = _run(name)
    assert not correct, (fault, result["checks"])
