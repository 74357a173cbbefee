"""Stage 2's fused optimizer tail (``train/optim_tail.py``) on the CPU: its
plain path bit for bit against the per-leaf composition that
``stage2.train_step`` ran before it (kept here as the reference), and the
chunk table its kernels walk.  The kernels themselves run on the card only
(``chip_smoke.py --phases env,build,optim_tail``)."""
import copy

import pytest
import torch

from gaussianhaircut_torch import kernels
from gaussianhaircut_torch.train import optim, optim_tail

SHAPES = {"a": (1,), "b": (3,), "c": (7, 7), "d": (4097,), "e": (3, 5, 7, 2)}
CLIP = {"loose": 1e6, "binding": 0.05, "none": 0.0}
CASES = {
    "plain": dict(clip="loose", ema=("c", "d", "e")),
    "clip_binding": dict(clip="binding", ema=("c", "d", "e")),
    "no_clip": dict(clip="none", ema=("a", "d")),
    "nan_leaf": dict(clip="binding", ema=("c", "d", "e"), nan="d"),
    "ema_subset": dict(clip="loose", ema=("b",)),
    "no_ema": dict(clip="binding", ema=()),
}


def composition_(params, grads, opt, ema_pairs, lr, clip, dk):
    """The per-leaf tail of ``stage2.train_step`` before the fused pass, as
    it was written there; returns (new optimizer state, grad norm or None)."""
    gnorm = None
    ok = optim.grads_are_finite(grads)
    if clip > 0:
        grads, gnorm = optim.clip_by_global_norm(grads, clip)
    with torch.no_grad():
        updates, new_opt = optim.adamw_update(
            grads, opt, {n: p.detach() for n, p in params.items()}, lr)
        for n, p in params.items():
            p.add_(torch.where(ok, updates[n], torch.zeros_like(updates[n])))
        new_opt = optim.where_ok(ok, new_opt, opt)
        for e, p in ema_pairs:
            e.copy_(dk * e + (1.0 - dk) * p)
    return new_opt, gnorm


def make_state(case, seed=0):
    gen = torch.Generator().manual_seed(seed)
    randn = lambda shape, s=1.0: s * torch.randn(shape, generator=gen)
    params = {n: torch.nn.Parameter(randn(s)) for n, s in SHAPES.items()}
    grads = {n: randn(s, 0.3) for n, s in SHAPES.items()}
    if "nan" in case:
        grads[case["nan"]][0] = float("nan")
    opt = optim.AdamState({n: randn(s, 0.01) for n, s in SHAPES.items()},
                          {n: randn(s, 0.01).square() for n, s in SHAPES.items()},
                          torch.tensor(6, dtype=torch.int32))
    ema = {n: randn(SHAPES[n]) for n in case["ema"]}
    return params, grads, opt, ema


@pytest.mark.parametrize("name", list(CASES))
def test_tail_plain_path_matches_composition(name):
    case = CASES[name]
    clip, lr, dk = CLIP[case["clip"]], 3e-4, 0.995
    params, grads, opt, ema = make_state(case)
    before = copy.deepcopy((params, opt, ema))
    r_params, r_grads, r_opt, r_ema = copy.deepcopy((params, grads, opt, ema))

    launches = dict(kernels.launches)
    norm_got = optim_tail.adamw_tail_(params, grads, opt, [(ema[n], params[n]) for n in ema],
                                      lr, clip, decay=dk)
    want_opt, want_norm = composition_(r_params, r_grads, r_opt,
                                       [(r_ema[n], r_params[n]) for n in r_ema], lr, clip, dk)

    assert kernels.launches == launches           # the CPU runs the composition
    for n in SHAPES:
        assert torch.equal(params[n], r_params[n]), n
        assert torch.equal(opt.mu[n], want_opt.mu[n]), n
        assert torch.equal(opt.nu[n], want_opt.nu[n]), n
    for n in ema:
        assert torch.equal(ema[n], r_ema[n]), n
    assert torch.equal(opt.count, want_opt.count)
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    # NaN on the NaN case in both
    torch.testing.assert_close(norm_got, want_norm if want_norm is not None
                               else optim.global_norm(grads), rtol=0, atol=0, equal_nan=True)

    b_params, b_opt, b_ema = before
    moved = lambda a, b: not torch.equal(a, b)
    if "nan" in case:
        assert torch.isnan(norm_got)
        assert int(opt.count) == int(b_opt.count)
        for n in SHAPES:
            assert torch.equal(params[n], b_params[n]), n
            assert torch.equal(opt.mu[n], b_opt.mu[n]) and torch.equal(opt.nu[n], b_opt.nu[n])
        assert all(moved(ema[n], b_ema[n]) for n in ema)
    else:
        assert int(opt.count) == int(b_opt.count) + 1
        assert all(moved(params[n], b_params[n]) for n in SHAPES)
        assert all(moved(ema[n], b_ema[n]) for n in ema)
        # the clip binds where asked to, and only there
        assert (float(norm) > clip > 0) == (case["clip"] == "binding")


def cell_sizes():
    """The element counts of the strand cell's 194 leaves (texture, the two
    decoders and the 52.3M-parameter UNet), from modules on the meta device."""
    from gaussianhaircut_torch.models.diffusion import Denoiser, DiffusionConfig
    from gaussianhaircut_torch.models.strand_prior import ColorDecoder, StrandDecoder
    from gaussianhaircut_torch.models.textured_strands import StrandParams
    with torch.device("meta"):
        params = StrandParams(torch.empty(256, 256, 129), StrandDecoder(length=100),
                              ColorDecoder(sh_degree=3),
                              Denoiser(DiffusionConfig(input_channels=64, input_size=32)))
    return [p.numel() for _, p in params.named_parameters()]


@pytest.mark.parametrize("layout", ["small", "boundaries", "cell"])
def test_chunk_table_covers_each_element_once(layout):
    """Every element in exactly one chunk, no chunk across a leaf's end,
    every chunk starting on a float4 boundary of its leaf, the chunks of each
    leaf in order and the leaves in order, all in one table."""
    sizes = {"small": [1, 3, 49, 4096, 4097, 0, 8192, 105],
             "boundaries": [4095, 4096, 4097, 0, 8191, 8193, 2, 12288],
             "cell": None}[layout] or cell_sizes()
    if layout == "cell":
        assert len(sizes) == 194 and sum(sizes) == 60_941_180
    starts = optim_tail.chunk_plan(sizes)
    assert len(starts) == len(sizes) + 1 and starts[0] == 0
    covered = [0] * len(sizes)
    last = -1
    for leaf, offset, length in optim_tail.chunk_ranges(sizes, starts):
        assert leaf >= last, "the leaves in order"
        assert offset % 4 == 0 and 0 < length <= optim_tail.CHUNK
        assert offset == covered[leaf], "chunks of a leaf in order, without gaps"
        assert offset + length <= sizes[leaf]
        covered[leaf] += length
        last = leaf
    assert covered == sizes


def test_chunk_table_refuses_more_leaves_than_it_holds():
    assert len(optim_tail.chunk_plan([1] * optim_tail.MAX_LEAVES)) == optim_tail.MAX_LEAVES + 1
    with pytest.raises(ValueError, match="leaves"):
        optim_tail.chunk_plan([1] * (optim_tail.MAX_LEAVES + 1))


@pytest.mark.parametrize("where", ["count", "grad", "mu", "nu", "ema"])
def test_tail_tables_refuse_a_tensor_off_the_parameters_device(where):
    """The kernels' table takes every tensor from the parameters' device: a
    count, gradient, moment or EMA elsewhere (here on the meta device)
    raises before anything is launched."""
    params, grads, opt, ema = make_state(CASES["plain"])
    off = lambda t: t.to("meta")
    if where == "count":
        opt = optim.AdamState(opt.mu, opt.nu, off(opt.count))
    elif where == "grad":
        grads["d"] = off(grads["d"])
    elif where in ("mu", "nu"):
        getattr(opt, where)["d"] = off(getattr(opt, where)["d"])
    else:
        ema["d"] = off(ema["d"])
    with pytest.raises(ValueError, match="on meta"):
        optim_tail.tail_tables(params, grads, opt, [(ema[n], params[n]) for n in ema])
