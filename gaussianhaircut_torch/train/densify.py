"""Adaptive density control at fixed slot capacity: masked clone / split /
prune (port of ``gaussianhaircut_tpu/train/densify.py``; reference
src/scene/gaussian_model.py:679-741 and train_gaussians.py:160-171).

New Gaussians go to free (dead) slots in index order, by rank; requests
beyond the free slots are dropped.  Every structural change zeroes the
affected Adam moment rows.  Everything stays on the device: no host sync.
"""
from __future__ import annotations

import torch

from gaussianhaircut_torch.models.gaussian_model import (
    GaussianAux, GaussianModelState, get_opacity, get_scaling,
)
from gaussianhaircut_torch.ops.quaternion import build_rotation
from gaussianhaircut_torch.train.optim import AdamState


def add_stats(aux: GaussianAux, viewspace_grad: torch.Tensor,
              radii: torch.Tensor, visibility: torch.Tensor) -> GaussianAux:
    """train_gaussians.py:163-164 + gaussian_model.py:739-741."""
    gn = torch.linalg.norm(viewspace_grad[:, :2], dim=-1)
    vis = visibility
    return GaussianAux(
        alive=aux.alive,
        max_radii2d=torch.where(vis, torch.maximum(aux.max_radii2d, radii.to(torch.float32)),
                                aux.max_radii2d),
        xyz_grad_accum=aux.xyz_grad_accum + torch.where(vis, gn, torch.zeros_like(gn)),
        denom=aux.denom + vis.to(torch.float32),
    )


def _scatter_rows(t: torch.Tensor, dest: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """t[dest] = src row-wise, rows with dest == len(t) dropped (they land
    on a scratch row that is cut off; in-range dests are distinct)."""
    ext = torch.cat([t, torch.zeros_like(t[:1])], 0)
    ext[dest] = src
    return ext[:-1]


def _set_rows(t: torch.Tensor, dest: torch.Tensor, value) -> torch.Tensor:
    ext = torch.cat([t, torch.zeros_like(t[:1])], 0)
    ext[dest] = value
    return ext[:-1]


def densify_and_prune(state: GaussianModelState, opt: AdamState,
                      samples: torch.Tensor, grad_threshold: float,
                      min_opacity: float, extent: float, max_screen_size,
                      percent_dense: float):
    """One densification round.  ``samples`` [2, C, 3] are the standard
    normal draws for the two children of every split (the trainer draws
    them from a seeded torch.Generator).  Returns (state, opt)."""
    p = state.params
    aux = state.aux
    cap = p.xyz.shape[0]
    alive = aux.alive

    grads = aux.xyz_grad_accum / torch.clamp(aux.denom, min=1.0)
    grads = torch.where(torch.isnan(grads) | ~alive, torch.zeros_like(grads), grads)

    scaling = get_scaling(p)
    max_scale = torch.max(scaling, dim=-1).values
    hot = grads >= grad_threshold
    clone_sel = hot & (max_scale <= percent_dense * extent) & alive
    split_sel = hot & (max_scale > percent_dense * extent) & alive

    # free slots: dead ones first, in index order
    free = torch.argsort(alive.to(torch.int32), stable=True)
    num_free = cap - alive.sum()
    n_clone = clone_sel.sum()
    nowhere = torch.full_like(free, cap)

    def slot(rank):
        return free[torch.clamp(rank, 0, cap - 1)]

    clone_rank = torch.cumsum(clone_sel, 0) - 1
    clone_dest = torch.where(clone_sel & (clone_rank < num_free), slot(clone_rank), nowhere)
    split_rank = torch.cumsum(split_sel, 0) - 1
    base = n_clone + 2 * split_rank
    split_ok = split_sel & (base + 1 < num_free)
    split_dest0 = torch.where(split_ok, slot(base), nowhere)
    split_dest1 = torch.where(split_ok, slot(base + 1), nowhere)

    # clone: copy raw rows (gaussian_model.py:706-721)
    new_params = p.map(lambda t: _scatter_rows(t, clone_dest, t))
    # split: sample children (gaussian_model.py:679-704)
    rot_m = build_rotation(p.rotation)
    child_scaling = torch.log(scaling / (0.8 * 2.0))
    for k, dest in enumerate((split_dest0, split_dest1)):
        child_xyz = torch.einsum("pij,pj->pi", rot_m, samples[k] * scaling) + p.xyz
        child = p.replace(xyz=child_xyz, scaling=child_scaling)
        new_params = new_params.map(lambda t, s: _scatter_rows(t, dest, s), child)

    new_alive = alive
    for dest in (clone_dest, split_dest0, split_dest1):
        new_alive = _set_rows(new_alive, dest, True)
    new_alive = torch.where(split_ok, torch.zeros_like(new_alive), new_alive)

    # prune (gaussian_model.py:725-735); the screen-radius test is dead code
    # in the reference (max_radii2D is zeroed before it is read), so only
    # the world-size test is active when max_screen_size is set
    prune = (get_opacity(new_params)[:, 0] < min_opacity) & new_alive
    if max_screen_size is not None:
        big_ws = torch.max(get_scaling(new_params), dim=-1).values > 0.1 * extent
        prune = prune | (big_ws & new_alive)
    new_alive = new_alive & ~prune

    new_mu, new_nu = opt.mu, opt.nu
    for dest in (clone_dest, split_dest0, split_dest1):
        new_mu = new_mu.map(lambda t: _set_rows(t, dest, 0.0))
        new_nu = new_nu.map(lambda t: _set_rows(t, dest, 0.0))

    zeros = torch.zeros(cap, dtype=torch.float32, device=alive.device)
    new_aux = GaussianAux(alive=new_alive, max_radii2d=zeros,
                          xyz_grad_accum=zeros.clone(), denom=zeros.clone())
    return (state.replace(params=new_params, aux=new_aux),
            AdamState(new_mu, new_nu, opt.count))


def reset_opacity(state: GaussianModelState, opt: AdamState):
    """Clamp opacity to <= 0.01 and zero its Adam moments
    (gaussian_model.py:516-519)."""
    p = state.params
    op = torch.clamp(get_opacity(p), max=0.01)
    new_params = p.replace(opacity=torch.log(op / (1.0 - op)))
    new_mu = opt.mu.replace(opacity=torch.zeros_like(opt.mu.opacity))
    new_nu = opt.nu.replace(opacity=torch.zeros_like(opt.nu.opacity))
    return state.replace(params=new_params), AdamState(new_mu, new_nu, opt.count)
