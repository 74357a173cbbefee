"""The precompute (``render/renderer.py: precompute``) on the CPU.

The card runs it as one forward and one backward kernel
(``csrc/precompute.cu``, wrapped by ``ops/precompute.py``); those run on the
card only (``chip_smoke.py --phases env,build,precompute``).  Here: the
kernels' hand-derived backward, as its float64 twin
(``tests/precompute_twin.py``), against autograd of the composition in
float64, on stage-1 and stage-2 fields and on Gaussians placed where the
maths branches; the CPU path bit for bit the composition; the wrapper's
checks and no launch counted on the CPU."""
import math

import pytest
import torch

from gaussianhaircut_torch import kernels
from gaussianhaircut_torch.ops import precompute as pre_ops
from gaussianhaircut_torch.ops import projection as proj
from gaussianhaircut_torch.ops import sh as sh_ops
from gaussianhaircut_torch.ops.quaternion import build_rotation, normalize
from gaussianhaircut_torch.render import renderer
from tests.precompute_twin import twin

W, H = 96, 64
FIELD_NAMES = ("xyz", "features", "scaling", "rotation_matrix", "label", "orient_conf",
               "viewspace")
CAM_NAMES = ("viewmatrix", "projmatrix", "campos", "tan_fovx", "tan_fovy")


def camera(dtype, pitch=0.3, fov=0.9):
    """A camera 3 units from the origin looking at it, pitched about the x
    axis and with no x offset (so that a view's x is the world's), as
    ``camera_geom`` builds one (row-vector matrices)."""
    c, s = math.cos(pitch), math.sin(pitch)
    w2c = torch.tensor([[1, 0, 0, 0], [0, c, -s, -0.05], [0, s, c, 3.0], [0, 0, 0, 1]],
                       dtype=dtype)
    from gaussianhaircut_torch.scene.cameras import projection_matrix
    fovx = torch.tensor(fov, dtype=dtype)
    fovy = torch.tensor(fov * H / W, dtype=dtype)
    view = w2c.T.contiguous()
    full = view @ projection_matrix(fovx, fovy).T.to(dtype)
    return {"viewmatrix": view, "projmatrix": full,
            "campos": torch.linalg.inv(view)[3, :3].contiguous(),
            "tan_fovx": torch.tan(fovx * 0.5), "tan_fovy": torch.tan(fovy * 0.5)}


def fields(n, k_rows, dtype, seed, stage2=False):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=dtype)
    q = rnd(n, 4)
    f = {"xyz": 0.6 * rnd(n, 3),
         "features": 0.4 * rnd(n, k_rows, 3),
         "scaling": torch.exp(rnd(n, 3) - 3.0),
         "rotation_matrix": build_rotation(q),
         "label": torch.rand(n, 1, generator=g, dtype=dtype),
         "orient_conf": torch.rand(n, 1, generator=g, dtype=dtype) + 0.5,
         "viewspace": torch.zeros(n, 3, dtype=dtype),
         "use_direction": None}
    if stage2:
        # strand segments: one long axis; the head's rows carry no direction
        f["scaling"][:, 0] = f["scaling"][:, 0] * 8.0
        f["use_direction"] = (torch.arange(n) % 3 != 0).to(dtype)
    return f


def plant_edges(f, cam, deg):
    """Rows 0-5 on the maths' branches: beyond and exactly on the
    1.3 tan_fov clamp on x and y, the rgb clamp at 0 (a channel's raw value
    exactly 0 and one below), a principal-axis tie, exactly on the clamp."""
    view = cam["viewmatrix"]
    inv = torch.linalg.inv(view)
    lim_x, lim_y = 1.3 * cam["tan_fovx"], 1.3 * cam["tan_fovy"]

    def at_view(row, t):
        f["xyz"][row] = (torch.cat([t, t.new_ones(1)]) @ inv)[:3]

    tz = torch.tensor(2.5, dtype=view.dtype)
    at_view(0, torch.stack([2.0 * lim_x * tz, 0.1 * tz, tz]))      # beyond +x
    at_view(1, torch.stack([0.2 * tz, -3.0 * lim_y * tz, tz]))     # beyond -y
    # on the x clamp exactly: at (x, 0, 0) the view's x is x and its z the
    # camera's offset, each exact in any order of summation; step x by ulps
    # until tx / tz is lim_x itself
    tz2 = float(view[3, 2])
    x = float(lim_x) * tz2
    for _ in range(64):
        q = x / tz2
        if q == float(lim_x):
            break
        x = math.nextafter(x, math.inf if q < float(lim_x) else -math.inf)
    f["xyz"][2] = torch.tensor([x, 0.0, 0.0], dtype=view.dtype)
    # the rgb clamp: channel 0's raw value 0 or below, from the DC row alone
    f["features"][3, 1:] = 0
    f["features"][3, 0, 0] = -0.5 / sh_ops.C0
    f["features"][4, 1:] = 0
    f["features"][4, 0, 0] = -0.75 / sh_ops.C0
    # a principal-axis tie: two equal largest scales (the first wins)
    f["scaling"][5] = torch.tensor([0.03, 0.05, 0.05], dtype=f["scaling"].dtype)
    return f


def geom(cam):
    return proj.CameraGeom(cam["viewmatrix"], cam["projmatrix"], cam["tan_fovx"],
                           cam["tan_fovy"], W, H, cam["campos"])


def as_fields(f):
    return renderer.GaussianFields(opacity=torch.ones_like(f["label"]),
                                   valid=torch.ones(f["xyz"].shape[0], dtype=torch.bool),
                                   **f)


CASES = {
    # name: (SH degree, SH rows stored, stage 2, camera gradients)
    "s1_deg0": (0, 16, False, True),
    "s1_deg1": (1, 16, False, True),
    "s1_deg2": (2, 16, False, True),
    "s1_deg3": (3, 16, False, True),
    "s2_deg3_frozen_camera": (3, 16, True, False),
    "s2_deg1_rows4_frozen_camera": (1, 4, True, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_twin_backward_matches_autograd(name):
    """The kernels' backward, formula by formula in float64, against
    autograd of the composition in float64: every input's gradient and the
    camera's, the forward outputs besides."""
    deg, k_rows, stage2, cam_grad = CASES[name]
    dt = torch.float64
    cam = camera(dt)
    f = plant_edges(fields(64, k_rows, dt, seed=deg + 10 * stage2, stage2=stage2), cam, deg)
    mod = 0.9
    leaves = {k: f[k].clone().requires_grad_(True) for k in FIELD_NAMES}
    cam_leaves = {k: cam[k].clone().requires_grad_(cam_grad) for k in CAM_NAMES}
    fl = as_fields({**f, **leaves})
    ndc, conic, colors, depth = renderer.precompute_plain(fl, deg, geom(cam_leaves), mod)
    g = torch.Generator().manual_seed(99)
    gout = {"ndc": torch.randn(ndc.shape, generator=g, dtype=dt),
            "conic": torch.randn(conic.shape, generator=g, dtype=dt),
            "colors": torch.randn(colors.shape, generator=g, dtype=dt),
            "depth": torch.randn(depth.shape, generator=g, dtype=dt)}
    loss = sum((o * gout[k]).sum() for k, o in
               zip(("ndc", "conic", "colors", "depth"), (ndc, conic, colors, depth)))
    wrt = list(leaves.values()) + ([cam_leaves[k] for k in CAM_NAMES] if cam_grad else [])
    auto = torch.autograd.grad(loss, wrt, allow_unused=True)
    out, grads, gcam = twin(f, cam, deg, mod, W, H, gout)

    # the planted rows do reach the branches they are meant to
    t = torch.cat([f["xyz"], torch.ones(64, 1, dtype=dt)], 1) @ cam["viewmatrix"]
    ux, uy = t[:, 0] / t[:, 2], t[:, 1] / t[:, 2]
    assert ux[0] > 1.3 * cam["tan_fovx"] and uy[1] < -1.3 * cam["tan_fovy"]
    assert ux[2] == 1.3 * cam["tan_fovx"]
    assert out["colors"][3, 0] == 0 and out["colors"][4, 0] == 0
    for got, want in zip((out["ndc"], out["conic"], out["colors"], out["depth"]),
                         (ndc, conic, colors, depth)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    names = list(FIELD_NAMES) + (list(CAM_NAMES) if cam_grad else [])
    mine = [grads[k] for k in FIELD_NAMES] + ([gcam[k] for k in CAM_NAMES] if cam_grad else [])
    for name_, got, want in zip(names, mine, auto):
        if want is None:   # campos at degree 0: no direction is read
            assert name_ == "campos" and deg == 0 and not got.any()
            continue
        scale = float(want.abs().max())
        assert scale > 0, f"{name_}: autograd's gradient is zero, so the check cannot fail"
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-11 * scale,
                                   msg=lambda m: f"{name}: {name_}: {m}")


def composition_before(fields, active_sh_degree, cam, scaling_modifier=1.0):
    """``renderer.prepare_raster_inputs`` before the fused kernels, as it
    was written there."""
    xyz = fields.xyz
    scaling = fields.scaling * scaling_modifier
    rot_m = fields.rotation_matrix

    cov3d = proj.covariance_3d(scaling, rot_m)
    cov2d = proj.covariance_2d(xyz, cov3d, cam)
    conic = proj.conic_from_cov2d(cov2d)
    ndc = proj.project_ndc(xyz, cam.projmatrix) + fields.viewspace
    depth = proj.depths(xyz, cam)

    dirs = normalize(xyz - cam.campos[None, :])
    rgb = torch.clamp(sh_ops.eval_sh(active_sh_degree, fields.features, dirs) + 0.5,
                      min=0.0)
    dir2d = proj.direction_2d(xyz, scaling, rot_m, cam)
    orient_conf = fields.orient_conf
    if fields.use_direction is not None:
        dir2d = dir2d * fields.use_direction[:, None]
        orient_conf = orient_conf * fields.use_direction[:, None]
    colors = torch.cat([rgb, fields.label, torch.ones_like(fields.label), dir2d,
                        orient_conf, depth], dim=-1)
    return ndc, conic, colors, fields.opacity, depth[:, 0], fields.valid


@pytest.mark.parametrize("stage2", [False, True])
def test_cpu_path_is_the_composition_bit_for_bit(stage2):
    """CPU fields take the composition: ``prepare_raster_inputs`` gives what
    it gave before the fused kernels, bit for bit, forward and backward
    (camera gradients included), and launches no kernel."""
    cam = camera(torch.float32)
    f = fields(200, 16, torch.float32, seed=3, stage2=stage2)
    runs = []
    launches = dict(kernels.launches)
    for fn in (renderer.prepare_raster_inputs, composition_before):
        leaves = {k: f[k].clone().requires_grad_(True) for k in FIELD_NAMES}
        cam_leaves = {k: cam[k].clone().requires_grad_(True) for k in CAM_NAMES}
        outs = fn(as_fields({**f, **leaves}), 3, geom(cam_leaves), 0.7)
        gen = torch.Generator().manual_seed(5)
        loss = sum((o * torch.randn(o.shape, generator=gen)).sum()
                   for o in outs if o.dtype == torch.float32 and o.requires_grad)
        grads = torch.autograd.grad(loss, list(leaves.values()) + list(cam_leaves.values()))
        runs.append((outs, grads))
    (got, ggot), (want, gwant) = runs
    assert len(got) == len(want) and len(ggot) == len(gwant)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(ggot, gwant))
    assert kernels.launches == launches


@pytest.mark.parametrize("deg", [-1, 4])
def test_cuda_path_refuses_an_sh_degree_it_does_not_take(deg):
    with pytest.raises(ValueError, match=f"SH degree {deg}"):
        pre_ops.check_degree(deg)


REFUSALS = {
    # name: (what to change in the float32 CPU fields, the message)
    "float64_xyz": (lambda f, c: f.update(xyz=f["xyz"].double()), "xyz is torch.float64"),
    "few_sh_rows": (lambda f, c: f.update(features=f["features"][:, :9]),
                    "features \\(50, 9, 3\\) hold no"),
    "flat_rotation": (lambda f, c: f.update(rotation_matrix=f["rotation_matrix"].reshape(50, 9)),
                      "rotation_matrix is"),
    "float64_camera": (lambda f, c: c.update(viewmatrix=c["viewmatrix"].double()),
                       "viewmatrix is torch.float64"),
    "cpu_fields": (lambda f, c: None, "expected CUDA fields, got cpu"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_cuda_path_checks_its_inputs(name):
    """The kernels' wrapper refuses what they do not take, each field and
    camera tensor by name, before it asks for the card."""
    edit, msg = REFUSALS[name]
    f = fields(50, 16, torch.float32, seed=1)
    cam = camera(torch.float32)
    edit(f, cam)
    with pytest.raises(ValueError, match=msg):
        pre_ops.precompute_cuda(*(f[k] for k in FIELD_NAMES), f["use_direction"], geom(cam), 3)
