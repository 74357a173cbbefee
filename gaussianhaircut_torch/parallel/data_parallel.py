"""Camera data parallelism over the ``data`` axis of a process mesh (port of
``gaussianhaircut_tpu/parallel/data_parallel.py``).

Every rank renders a different training view against replicated Gaussian
parameters.  Gaussian gradients are averaged over ``data`` and the
replicated Adam step runs identically on every rank, so the ranks stay
bit-identical.  Per-camera residual gradients live on disjoint rows, so a
plain sum reassembles each camera's gradient at full strength.  The densify
statistics add up as over that many sequential reference iterations: the
viewspace-gradient norm and the visibility count are summed, the radii
maxed.  The reference trains on one GPU only (SURVEY.md §2.3).
"""
from __future__ import annotations

import torch

from gaussianhaircut_torch.config import OptimizationConfig
from gaussianhaircut_torch.models.gaussian_model import GaussianAux, GaussianParams
from gaussianhaircut_torch.parallel import collectives as coll
from gaussianhaircut_torch.parallel.mesh import Mesh
from gaussianhaircut_torch.scene.cameras import CameraResiduals
from gaussianhaircut_torch.train import stage1


def reduce_and_update(mesh: Mesh, state: stage1.TrainState, gparams: GaussianParams,
                      gcam: CameraResiduals, vis: torch.Tensor, radii: torch.Tensor,
                      parts: dict, num_rendered: int, cam_idxs, *,
                      opt_cfg: OptimizationConfig, trainable_cameras: bool,
                      trainable_intrinsics: bool):
    """The step after this rank's gradients of its camera (whole-camera
    gradients and visibility: the tile axis already summed): one sum over
    ``data`` of the Gaussian and camera gradients, the viewspace-gradient
    norm, the visibility and the loss terms; one max over the world of the
    radii and ``num_rendered``; then the update of ``stage1.apply_grads``
    on every rank.  Returns (new_state, metrics) as ``stage1.train_step``."""
    gn = torch.linalg.norm(stage1.safe_viewspace(gparams)[:, :2], dim=-1)
    gn = torch.where(vis, gn, torch.zeros_like(gn))
    names = list(parts)
    like = (gparams.values() + gcam.values()
            + [gn, vis.to(torch.float32)] + [parts[k].detach() for k in names])
    flat = coll.all_reduce(mesh, coll.flatten(like), "data", "sum")
    red = coll.unflatten(flat, like)
    n_p, n_c = len(gparams.values()), len(gcam.values())
    gparams_red = GaussianParams(*(g / mesh.n_data for g in red[:n_p]))
    gcam_red = CameraResiduals(*red[n_p:n_p + n_c])
    gn_sum, vis_count = red[n_p + n_c], red[n_p + n_c + 1]
    metrics = {k: v / mesh.n_data for k, v in zip(names, red[n_p + n_c + 2:])}
    # capacity health is a max over ranks: a mean would hide the worst one
    mx = torch.cat([radii.to(torch.int64),
                    torch.tensor([num_rendered], dtype=torch.int64, device=radii.device)])
    coll.all_reduce(mesh, mx, "world", "max")

    aux = state.model.aux
    new_aux = GaussianAux(alive=aux.alive,
                          max_radii2d=torch.maximum(aux.max_radii2d, mx[:-1].to(torch.float32)),
                          xyz_grad_accum=aux.xyz_grad_accum + gn_sum,
                          denom=aux.denom + vis_count)
    # the rows every data rank drew: JAX's psum of one-hot rows, clamped
    # to 1; every rank holds the whole list, so it needs no collective
    drawn = torch.zeros(len(state.cam_opt.count), device=gn.device)
    drawn[list(cam_idxs)] = 1.0
    new_state, ok = stage1.apply_grads(
        state, gparams_red, gcam_red, new_aux, drawn, opt_cfg=opt_cfg,
        trainable_cameras=trainable_cameras, trainable_intrinsics=trainable_intrinsics)
    metrics["num_rendered"] = int(mx[-1])
    metrics["grads_ok"] = ok
    return new_state, metrics


def dp_train_step(mesh: Mesh, **step_kw):
    """The camera data-parallel step on an ``n x 1`` mesh: the tile-row
    step's camera-only case (one window of the whole image per camera is
    ``render``), so it is ``tile_parallel.dp_tp_train_step``.

    Returns ``step(state, cam_batch, gt, cam_idxs) -> (state, metrics)``:
    ``cam_idxs`` holds one camera per data rank, the same list on every
    rank, and data rank d renders ``cam_idxs[d]``."""
    # imported here: tile_parallel imports this module's reduce_and_update
    from gaussianhaircut_torch.parallel.tile_parallel import dp_tp_train_step
    if mesh.n_tile != 1:
        raise ValueError(f"dp_train_step takes an n x 1 mesh, not {mesh.n_data}x{mesh.n_tile}")
    return dp_tp_train_step(mesh, **step_kw)
