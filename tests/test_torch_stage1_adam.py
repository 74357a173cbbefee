"""Stage 1's optimizer (``stage1.apply_grads`` -> ``optim_tail.adam_guarded``)
on the CPU: its plain path bit for bit against the composition that
``apply_grads`` ran before the fused pass (kept here as the reference), the
guard of the Gaussian leaves and of the camera rows, and the table the
kernels walk (per-leaf learning rates, the guard's members, the row
leaves).  The kernels themselves run on the card only: the ``card`` case
below skips without one (on the card: ``python3 -m pytest --noconftest -m
card tests/test_torch_stage1_adam.py``), and ``chip_smoke.py``'s
``optim_tail`` phase holds them at the stage-1 cell's layout."""
import dataclasses
import math

import pytest
import torch

from gaussianhaircut_torch import kernels
from gaussianhaircut_torch.config import OptimizationConfig
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.records import TensorRecord
from gaussianhaircut_torch.scene.cameras import CameraResiduals
from gaussianhaircut_torch.train import optim, optim_tail, stage1

P, N_CAMS, SH_REST = 37, 5, 15
OPT = OptimizationConfig(iterations_cam=50)
CASES = {
    # name: (drawn rows, step, trainable cameras, the leaf given a NaN gradient)
    "plain": ((2,), 7, True, None),
    "two_rows": ((0, 3), 7, True, None),
    "nan_gaussian": ((2,), 7, True, "features_rest"),
    "nan_viewspace": ((2,), 7, True, "viewspace"),
    "nan_camera": ((2,), 7, True, "cam.translation"),
    "cameras_off": ((2,), 50, True, None),
    "frozen_cameras": ((2,), 7, False, None),
}


def composition(state, gparams, gcam, drawn, opt_cfg, trainable):
    """The update of ``stage1.apply_grads`` before the fused pass, as it was
    written there (with its ``_camera_adam``); returns (params, opt,
    cam_res, cam_opt, ok)."""
    ok = optim.grads_are_finite(
        gparams.replace(viewspace=torch.zeros_like(gparams.viewspace)))
    lrs = stage1.param_lrs(opt_cfg, state.model.spatial_lr_scale, state.step)
    updates, new_opt = optim.adam_update(gparams, state.opt, lrs)
    with torch.no_grad():
        new_params = state.model.params.map(
            lambda p, u: p + torch.where(ok, u, torch.zeros_like(u)), updates)
        new_opt = optim.where_ok(ok, new_opt, state.opt)
        if not trainable:
            return new_params, new_opt, state.cam_res, state.cam_opt, ok
        do_cam = optim.grads_are_finite(gcam) & (state.step < opt_cfg.iterations_cam)
        clrs = stage1.cam_lrs(opt_cfg, state.model.spatial_lr_scale, state.step)
        sel = (drawn * do_cam.to(torch.float32))[:, None] > 0
        count = state.cam_opt.count + sel[:, 0].to(torch.int32)
        cnt = torch.clamp(count, min=1).to(torch.float32)[:, None]
        b1, b2, eps = 0.9, 0.999, 1e-15
        c1 = 1 - torch.pow(b1, cnt)
        c2 = 1 - torch.pow(b2, cnt)
        mus, nus, ress = {}, {}, {}
        for name in CameraResiduals.names():
            mu, nu = getattr(state.cam_opt.mu, name), getattr(state.cam_opt.nu, name)
            g, res = getattr(gcam, name), getattr(state.cam_res, name)
            lr = getattr(clrs, name)
            mus[name] = torch.where(sel, b1 * mu + (1 - b1) * g, mu)
            nus[name] = torch.where(sel, b2 * nu + (1 - b2) * g ** 2, nu)
            step_row = -lr * (mus[name] / c1) / (torch.sqrt(nus[name] / c2) + eps)
            ress[name] = res + torch.where(sel, step_row, torch.zeros_like(step_row))
    return (new_params, new_opt, CameraResiduals(**ress),
            stage1.CamAdamState(CameraResiduals(**mus), CameraResiduals(**nus), count), ok)


def make_step(seed=0, device="cpu", step=7, nan=None, p=P):
    """A train state mid-run (moments, counts and camera rows that have
    moved) and one step's gradients, drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    rand = lambda *shape, s=1.0: (s * torch.randn(*shape, generator=gen)).to(device)
    shapes = {"xyz": (p, 3), "features_dc": (p, 1, 3), "features_rest": (p, SH_REST, 3),
              "scaling": (p, 3), "rotation": (p, 4), "opacity": (p, 1), "label": (p, 1),
              "orient_conf": (p, 1), "viewspace": (p, 3)}
    rec = lambda s: gm.GaussianParams(**{n: rand(*shape, s=s) for n, shape in shapes.items()})
    params = rec(1.0)
    aux = gm.GaussianAux(alive=torch.ones(p, dtype=torch.bool, device=device),
                         max_radii2d=rand(p).abs(), xyz_grad_accum=rand(p).abs(),
                         denom=rand(p).abs())
    model = gm.GaussianModelState(params, aux, 3, 3, 2.5)
    opt = optim.AdamState(rec(1e-3), rec(1e-3).map(torch.square),
                          torch.tensor(step, dtype=torch.int32, device=device))
    cam_shapes = {"rotation": (N_CAMS, 3), "translation": (N_CAMS, 3), "fov": (N_CAMS, 2)}
    cam = lambda s: CameraResiduals(**{n: rand(*sh, s=s) for n, sh in cam_shapes.items()})
    cam_opt = stage1.CamAdamState(cam(1e-3), cam(1e-3).map(torch.square),
                                  torch.tensor([0, 3, 1, 2, 5], dtype=torch.int32,
                                               device=device))
    state = stage1.TrainState(model, opt, cam(1e-2), cam_opt, step)
    gparams, gcam = rec(1e-2), cam(1e-2)
    if nan is not None:
        if nan.startswith("cam."):
            getattr(gcam, nan[4:]).view(-1)[4] = float("nan")
        else:
            getattr(gparams, nan).view(-1)[5] = float("nan")
    return state, gparams, gcam


def same(a, b) -> bool:
    """Bit for bit: the dtype, the shape and every bit (NaN payloads and the
    sign of zero included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def drawn_rows(rows, device="cpu"):
    drawn = torch.zeros(N_CAMS, device=device)
    drawn[list(rows)] = 1.0
    return drawn


def tensors(params, opt, cam_res, cam_opt):
    """Every tensor of an update's result, by name."""
    out = {f"p.{n}": getattr(params, n) for n in params.names()}
    out.update({f"m.{n}": getattr(opt.mu, n) for n in params.names()})
    out.update({f"v.{n}": getattr(opt.nu, n) for n in params.names()})
    out["count"] = opt.count
    out.update({f"cam.{n}": getattr(cam_res, n) for n in cam_res.names()})
    out.update({f"cam_m.{n}": getattr(cam_opt.mu, n) for n in cam_res.names()})
    out.update({f"cam_v.{n}": getattr(cam_opt.nu, n) for n in cam_res.names()})
    out["cam_count"] = cam_opt.count
    return out


def apply(state, gparams, gcam, drawn, trainable):
    return stage1.apply_grads(state, gparams, gcam, state.model.aux, drawn, opt_cfg=OPT,
                              trainable_cameras=trainable, trainable_intrinsics=trainable)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_path_matches_composition(name):
    rows, step, trainable, nan = CASES[name]
    state, gparams, gcam = make_step(step=step, nan=nan)
    drawn = drawn_rows(rows)
    before = {k: t.clone() for k, t in tensors(state.model.params, state.opt, state.cam_res,
                                                state.cam_opt).items()}
    launches = dict(kernels.launches)
    new, ok = apply(state, gparams, gcam, drawn, trainable)
    *want, want_ok = composition(state, gparams, gcam, drawn, OPT, trainable)

    assert kernels.launches == launches           # the CPU runs the composition
    got = tensors(new.model.params, new.opt, new.cam_res, new.cam_opt)
    want = tensors(*want)
    for k in want:
        assert same(got[k], want[k]), k
    assert same(ok, want_ok) and new.step == step + 1
    # the caller's state is left as it was
    for k, t in tensors(state.model.params, state.opt, state.cam_res, state.cam_opt).items():
        assert same(t, before[k]), k

    moved = {k for k in got if not torch.equal(got[k], before[k])}
    gauss = {k for k in got if not k.startswith("cam")}
    if nan in ("features_rest",):
        assert not bool(ok) and not moved & gauss
    else:
        assert bool(ok)
        # viewspace's lr is 0: its parameter stays, its moments move; a NaN
        # in its gradient, which the guard leaves out, reaches its moments
        # and, through 0 * NaN, the parameter
        assert moved & gauss == gauss - ({"p.viewspace"} if nan != "viewspace" else set())
    cams_step = trainable and nan != "cam.translation" and step < OPT.iterations_cam
    cam_moved = {k for k in moved if k.startswith("cam")}
    if not cams_step:
        assert not cam_moved
        return
    assert cam_moved == {k for k in got if k.startswith("cam")}
    # only the drawn rows move, each row's count on its own
    assert torch.equal(got["cam_count"], before["cam_count"] + drawn.to(torch.int32))
    for k in cam_moved - {"cam_count"}:
        changed = (got[k] != before[k]).any(dim=1)
        assert torch.equal(changed, drawn > 0), k


def test_plain_path_over_three_steps():
    """Three steps, the second with a NaN in one Gaussian leaf: the state
    each returns feeds the next, and each equals the composition's."""
    state, _, _ = make_step(seed=1)
    want_state = state
    for k, nan in enumerate((None, "opacity", None)):
        _, gparams, gcam = make_step(seed=10 + k, nan=nan)
        drawn = drawn_rows((k,))
        state, ok = apply(state, gparams, gcam, drawn, True)
        *want, want_ok = composition(want_state, gparams, gcam, drawn, OPT, True)
        want_state = stage1.TrainState(want_state.model.replace(params=want[0]), want[1],
                                       want[2], want[3], want_state.step + 1)
        assert bool(ok) == (nan is None)
        got_t = tensors(state.model.params, state.opt, state.cam_res, state.cam_opt)
        for name, t in tensors(*want).items():
            assert same(got_t[name], t), (k, name)
    assert int(state.opt.count) == 7 + 2


def plan(state, gparams, gcam, drawn, step=7):
    rows = optim_tail.Rows(state.cam_res, gcam, state.cam_opt.mu, state.cam_opt.nu,
                           state.cam_opt.count, drawn,
                           stage1.cam_lrs(OPT, state.model.spatial_lr_scale, step), True)
    lrs = stage1.param_lrs(OPT, state.model.spatial_lr_scale, step)
    return optim_tail.adam_table(state.model.params, gparams, state.opt, lrs, rows), lrs, rows


def test_table_plan_per_leaf():
    """One table over the nine Gaussian leaves and the three camera-row
    leaves: each leaf's -lr as float (viewspace's lr 0 as -0.0), the guard's
    members (all but viewspace), the row leaves' widths, every pointer, and
    fresh outputs of each leaf's shape; the features' gradients, autograd's
    slices of one tensor, go in where they lie, as rows of a stride."""
    state, gparams, gcam = make_step()
    # autograd's gradient of a slice of a concatenation is a strided view
    whole = torch.randn(P, 1 + SH_REST, 3)
    gparams = gparams.replace(features_dc=whole[:, :1], features_rest=whole[:, 1:])
    assert not gparams.features_rest.is_contiguous()
    (t, outs, grid), lrs, rows = plan(state, gparams, gcam, drawn_rows((1,)))
    names = list(gm.GaussianParams.names()) + [f"cam.{n}" for n in CameraResiduals.names()]
    assert t.num_leaves == len(names) == 12 and grid == 1
    assert len(outs) == 2 and list(outs[0]) == list(gm.GaussianParams.names())
    sizes = []
    for i, name in enumerate(names):
        is_row = name.startswith("cam.")
        leaf = name[4:] if is_row else name
        p, g, m, v, lr = ((getattr(state.cam_res, leaf), getattr(gcam, leaf),
                           getattr(state.cam_opt.mu, leaf), getattr(state.cam_opt.nu, leaf),
                           getattr(rows.lrs, leaf)) if is_row else
                          (getattr(state.model.params, leaf), getattr(gparams, leaf),
                           getattr(state.opt.mu, leaf), getattr(state.opt.nu, leaf),
                           getattr(lrs, leaf)))
        assert t.neg_lr[i] == torch.tensor(-lr, dtype=torch.float32).item(), name
        assert math.copysign(1.0, t.neg_lr[i]) == -1.0, name
        assert t.guarded[i] == int(name != "viewspace"), name
        assert t.row_width[i] == (p.shape[1] if is_row else 0), name
        assert t.numel[i] == p.numel()
        assert (t.p[i], t.m[i], t.v[i]) == (p.data_ptr(), m.data_ptr(), v.data_ptr()), name
        assert t.g[i] == g.data_ptr(), name
        rows_of = {"features_dc": (3, 48), "features_rest": (3 * SH_REST, 48)}
        assert (t.g_width[i], t.g_stride[i]) == rows_of.get(name, (0, 0)), name
        out = outs[1 if is_row else 0][leaf]
        assert [o.shape for o in out] == [p.shape] * 3
        assert (t.p_out[i], t.m_out[i], t.v_out[i]) == tuple(o.data_ptr() for o in out)
        sizes.append(p.numel())
    assert getattr(lrs, "viewspace") == 0.0 and t.neg_lr[names.index("viewspace")] == 0.0
    starts = optim_tail.chunk_plan(sizes, optim_tail.ADAM_MAX_LEAVES)
    assert list(t.chunk_start[:len(starts)]) == starts and t.num_chunks == starts[-1]


@pytest.mark.parametrize("fault", ["rows_shape", "count_device", "grad_device", "drawn_dtype",
                                   "grad_layout", "too_many_leaves"])
def test_table_refuses(fault):
    """The table refuses, before anything is launched: a row leaf that does
    not hold the rows' count of rows, a count or gradient off the parameters'
    device (here on the meta device), a float64 ``drawn``, a gradient whose
    rows are not contiguous (a transposed one), and more leaves than it
    holds."""
    state, gparams, gcam = make_step()
    drawn = drawn_rows((1,))
    if fault == "rows_shape":
        gcam = gcam.replace(fov=gcam.fov[:-1])
        state = dataclasses.replace(state, cam_res=state.cam_res.replace(
            fov=state.cam_res.fov[:-1]))
    elif fault == "count_device":
        state = dataclasses.replace(state, opt=optim.AdamState(
            state.opt.mu, state.opt.nu, state.opt.count.to("meta")))
    elif fault == "grad_device":
        gparams = gparams.replace(xyz=gparams.xyz.to("meta"))
    elif fault == "drawn_dtype":
        drawn = drawn.double()
    elif fault == "grad_layout":
        gparams = gparams.replace(xyz=gparams.xyz.t().contiguous().t())
    if fault == "too_many_leaves":
        names = [f"l{i}" for i in range(optim_tail.ADAM_MAX_LEAVES + 1)]
        many = dataclasses.make_dataclass("Many", names, bases=(TensorRecord,))
        leaves = many(**{n: torch.zeros(3) for n in names})
        opt = optim.AdamState(leaves, leaves, torch.zeros((), dtype=torch.int32))
        with pytest.raises(ValueError, match="leaves"):
            optim_tail.adam_table(leaves, leaves, opt, many(**{n: 1.0 for n in names}))
        return
    with pytest.raises(ValueError, match={"rows_shape": "rows", "count_device": "on meta",
                                          "grad_device": "on meta", "drawn_dtype": "float64",
                                          "grad_layout": "rows of a stride"}[fault]):
        plan(state, gparams, gcam, drawn)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU version")
    return torch.device("cuda")


@pytest.mark.card
def test_kernel_matches_composition_on_the_card(card):
    """The kernels against the composition on the card, bit for bit, over
    three steps with a NaN in a Gaussian leaf on the second and the cameras
    off (step >= iterations_cam) on the third; one launch of each kernel a
    step."""
    p = 5000                # more than one chunk in the larger leaves
    state, _, _ = make_step(seed=1, device=card, p=p)
    want_state = state
    for k, (nan, step) in enumerate(((None, 7), ("scaling", 8), (None, 50))):
        _, gparams, gcam = make_step(seed=10 + k, device=card, nan=nan, p=p)
        state = dataclasses.replace(state, step=step)
        want_state = dataclasses.replace(want_state, step=step)
        drawn = drawn_rows((k, 4), card)
        kernels.reset_launch_counts()
        state, ok = apply(state, gparams, gcam, drawn, True)
        assert kernels.launches["optim_tail_adam_guard"] == 1
        assert kernels.launches["optim_tail_adam_update"] == 1
        *want, want_ok = composition(want_state, gparams, gcam, drawn, OPT, True)
        want_state = stage1.TrainState(want_state.model.replace(params=want[0]), want[1],
                                       want[2], want[3], want_state.step + 1)
        torch.cuda.synchronize()
        assert bool(ok) == bool(want_ok) == (nan is None)
        got_t = tensors(state.model.params, state.opt, state.cam_res, state.cam_opt)
        for name, t in tensors(*want).items():
            assert same(got_t[name], t), (k, name)


@pytest.mark.card
def test_bias_corrections_at_every_count_on_the_card(card):
    """The kernels' c1 and c2 (one powf for both forms) against the
    composition's torch.pow on the card at every step count from 1 to
    stage 1's iterations: one row leaf whose row r has count r, every row
    drawn, 32 random elements a row, so that a c1 or c2 an ulp off moves
    some row's parameters."""
    n = OptimizationConfig().iterations
    gen = torch.Generator().manual_seed(3)
    rand = lambda s: (s * torch.randn(n, 32, generator=gen)).to(card)
    res = lambda s: CameraResiduals(rotation=rand(s), translation=rand(s), fov=rand(s))
    count = torch.arange(n, dtype=torch.int32, device=card)
    drawn = torch.ones(n, device=card)
    lrs = CameraResiduals(rotation=1e-3, translation=1e-2, fov=1e-4)
    rows = optim_tail.Rows(res(1.0), res(1e-2), res(1e-3), res(1e-3).map(torch.square), count,
                           drawn, lrs, True)
    state, _, _ = make_step(device=card)
    *_, (got_p, got) = optim_tail.adam_guarded(state.model.params, make_step(device=card)[1],
                                               state.opt, stage1.param_lrs(OPT, 2.5, 7), rows)
    want_p, want = optim.adam_rows_update(rows.params, rows.grads,
                                          optim.AdamState(rows.mu, rows.nu, count), drawn, lrs,
                                          True)
    torch.cuda.synchronize()
    assert torch.equal(got.count, count + 1)
    for name in CameraResiduals.names():
        assert same(getattr(got_p, name), getattr(want_p, name)), name
        assert same(getattr(got.mu, name), getattr(want.mu, name)), name
        assert same(getattr(got.nu, name), getattr(want.nu, name)), name
