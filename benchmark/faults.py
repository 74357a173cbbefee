"""Faults planted in the port, for the tests that show the comparison fails
a broken step and for the calibration of its limits (``calibrate.py``).
Never used by a benchmark run.

- ``unchanged``: the step returns its state unchanged (it still computes,
  on a copy, and reports its metrics);
- ``half_batch``: half of the view's pixel rows left out of the loss, the
  mean taken over the rest;
- ``altered_tile``: the compositing forward's answer altered where it is
  produced: one tile's colours and transmittance halved.

A training cell on one card has no exchange between chips, so that fault
does not apply.

``rect3sigma`` is no fault but another path of the port, a witness: its
binning with the 3-sigma tile rect of the reference (``preprocess`` without
``opacity``) instead of the timed path's shrunken "exact-skip" rect.
"""
from __future__ import annotations

import contextlib
import copy

FAULTS = ("unchanged", "half_batch", "altered_tile")


def _half_rows(fn):
    def losses(out, gt_image, gt_mask, *rest, **kw):
        h = gt_image.shape[1] // 2
        cut = {k: (v[:, :h] if k in ("render", "mask", "orient_angle", "orient_conf") else v)
               for k, v in out.items()}
        return fn(cut, gt_image[:, :h], gt_mask[:, :h], *(r[:, :h] for r in rest[:2]),
                  *rest[2:], **kw)
    return losses


def _unchanged(real):
    def step(state, *args, **kw):
        _, metrics = real(copy.deepcopy(state), *args, **kw)
        return state, metrics
    return step


@contextlib.contextmanager
def planted(name: str):
    """Plant fault ``name`` in the port for the duration of the block (a
    driver built inside it takes the faulty step)."""
    from gaussianhaircut_torch.ops.rasterize import cuda_core
    from gaussianhaircut_torch.train import stage1, stage2

    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "unchanged":
        patch(stage1, "train_step", _unchanged(stage1.train_step))
        patch(stage2, "train_step", _unchanged(stage2.train_step))
    elif name == "half_batch":
        patch(stage1, "compute_losses", _half_rows(stage1.compute_losses))
        patch(stage2, "stage2_losses", _half_rows(stage2.stage2_losses))
    elif name == "rect3sigma":
        from gaussianhaircut_torch.ops.rasterize import api
        preprocess = api.C.preprocess
        patch(api.C, "preprocess", lambda *a, opacity=None, **k: preprocess(*a, **k))
    elif name == "altered_tile":
        real_fwd = cuda_core.raster_fwd

        def altered(*args, **kw):
            buf = real_fwd(*args, **kw).clone()
            buf[buf.shape[0] // 2] *= 0.5
            return buf
        patch(cuda_core, "raster_fwd", altered)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
