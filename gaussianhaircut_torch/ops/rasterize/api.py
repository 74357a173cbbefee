"""Public differentiable rasterization API (port of
``gaussianhaircut_tpu/ops/rasterize/api.py``).

``rasterize`` is one ``torch.autograd.Function`` spanning binning, the
compositing kernel and image assembly, as the JAX package's
``jax.custom_vjp`` does.  Autograd never sees the payload gather (its
backward, ``index_add_``, would use float atomics on CUDA).  The backward
runs the compositing backward to per-instance gradients, then reduces them
to per-Gaussian gradients deterministically: a gather into expansion order
(where each Gaussian's instances are contiguous) and a float64 cumulative-sum
difference per segment.  No float atomics anywhere, so a backward is
bit-reproducible.  The tensors' device picks the compositing route
(``cuda_core``): CUDA tensors launch the kernels, CPU tensors run their
plain versions.  ``rasterize_batched`` renders B cameras through the same
Function: one binning, one launch of each kernel over a virtual grid of B
images, one segment reduction.

Gradient routing matches the reference: the NDC->pixel factors W/2, H/2 are
applied here (backward.cu:462-465); depth orders but never differentiates;
bg receives sum(T_final * g).
"""
from __future__ import annotations

from typing import Any

import torch

from gaussianhaircut_torch.ops.rasterize import common as C
from gaussianhaircut_torch.ops.rasterize import cuda_core


def ndc_xy_to_pixel(ndc: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[P, >=2] NDC -> [P, 2] pixel centers (cuda ndc2Pix)."""
    size = torch.tensor([width, height], dtype=ndc.dtype, device=ndc.device)
    return ((ndc[:, :2] + 1.0) * size - 1.0) * 0.5


def segment_sum(dpay: torch.Tensor, binned: C.Binned) -> torch.Tensor:
    """Per-instance gradient rows dpay [TC, 16, CH] -> per-Gaussian sums
    [P, 16], in a fixed order: instances are gathered into expansion order,
    where Gaussian g owns rows [offset_g, offset_g + count_g), and each
    segment is a difference of one float64 inclusive cumulative sum."""
    # instance axis innermost: a scan along the last dimension runs in
    # parallel over it (along dim 0 of [N, 16] it would be 16 serial scans)
    cols = dpay.transpose(0, 1).reshape(C.GRAD_ROWS, -1)
    inst = cols[:, binned.slot_of_instance].to(torch.float64)
    csum = torch.cat([torch.zeros_like(inst[:, :1]), torch.cumsum(inst, 1)], 1)
    off = binned.gauss_offset
    seg = csum[:, off + binned.gauss_count] - csum[:, off]
    return seg.T.to(torch.float32)


class _Rasterize(torch.autograd.Function):
    """Inputs [P, ...], or a flattened batch [B * P, ...] of B cameras'
    Gaussians when ``n_batch`` is B (then the outputs carry a leading B
    axis: image [B, 10, H, W], final_T [B, H, W], radii and visibility
    [B, P])."""

    @staticmethod
    def forward(ctx, ndc, conic, colors, opacity, depth, valid, bg, width,
                height, full_height, row0, n_batch, cfg, info):
        mean_pix = ndc_xy_to_pixel(ndc, width, full_height)
        pre = C.preprocess(mean_pix, conic, depth, valid, width, height, cfg,
                           opacity=opacity, row0=row0)
        binned = C.bin_instances(pre, mean_pix, conic, opacity, colors, depth,
                                 width, height, cfg, n_batch=n_batch or 1)
        tile_buf = cuda_core.raster_fwd(binned.payload, binned.chunk_start, binned.nchunks,
                                        width, height, cfg, row0)
        image, t_final = C.assemble_image(tile_buf, bg, width, height, cfg, n_batch)
        info["num_rendered"] = binned.num_rendered
        info["num_rendered_bound"] = binned.num_rendered_bound
        ctx.binned = binned
        ctx.dims = (width, height, full_height, row0, cfg)
        ctx.save_for_backward(tile_buf, bg, t_final)
        radii = pre.radius.to(torch.int32)
        visibility = pre.radius > 0
        if n_batch is not None:
            radii, visibility = radii.reshape(n_batch, -1), visibility.reshape(n_batch, -1)
        ctx.mark_non_differentiable(radii, visibility)
        return image, t_final, radii, visibility

    @staticmethod
    def backward(ctx, g_img, g_t, _g_radii, _g_vis):
        tile_buf, bg, t_final = ctx.saved_tensors
        width, height, full_height, row0, cfg = ctx.dims
        b = ctx.binned
        gbuf = C.disassemble_cotangent(g_img, g_t, bg, width, height, cfg)
        dpay = cuda_core.raster_bwd(b.payload, b.chunk_start, b.nchunks,
                                    tile_buf, gbuf, width, height, cfg, row0)
        seg = segment_sum(dpay, b)
        d_ndc = torch.stack([seg[:, C.F_GX] * (width * 0.5),
                             seg[:, C.F_GY] * (full_height * 0.5),
                             torch.zeros_like(seg[:, 0])], dim=-1)
        d_conic = seg[:, C.F_CA:C.F_CC + 1]
        d_opacity = seg[:, C.F_OP:C.F_OP + 1]
        d_colors = seg[:, 6:6 + C.NUM_CHANNELS]
        # sum over cameras and pixels of T_final * g
        d_bg = torch.einsum("chw,hw->c" if g_img.dim() == 3 else "bchw,bhw->c",
                            g_img, t_final)
        d_bg = torch.nn.functional.pad(d_bg, (0, bg.shape[0] - C.NUM_CHANNELS))
        return (d_ndc, d_conic, d_colors, d_opacity, None, None, d_bg,
                None, None, None, None, None, None, None)


def rasterize(ndc: torch.Tensor, conic: torch.Tensor, colors: torch.Tensor,
              opacity: torch.Tensor, depth: torch.Tensor, valid: torch.Tensor,
              bg: torch.Tensor, width: int, height: int,
              cfg: C.RasterConfig | None = None,
              full_height: int | None = None, row0: int = 0) -> dict[str, Any]:
    """Differentiable 10-channel Gaussian splatting (one camera).

    ndc [P, 3] NDC means (xy used); conic [P, 3]; colors [P, 10];
    opacity [P, 1] activated; depth [P] view z (sort key, not
    differentiated); valid [P] bool; bg [10].
    ``full_height`` and ``row0`` are the row-window hook of the tile-row
    mesh step: NDC maps to pixels (and the gradient back) with the full
    image's height, and the grid and the kernels cover rows [row0, row0 +
    height) of it (``row0`` a whole number of tile rows).  The JAX package
    shifts ndc_y by -2*row0/full_height instead.  Here the means stay in
    the image's pixels and the grid's origin moves: binning takes the
    image's tile rect shifted by row0's tile rows and the kernels add row0
    to each tile's pixel rows, so every tile of a window gets the image's
    instances, in the image's order, against the image's pixel
    coordinates.  A window's pixels are the full render's bit for bit
    (alpha tests and early stops included) wherever the Gaussians lie.
    Returns render [10, H, W], final_T [H, W], radii [P] int32,
    visibility [P] bool and num_rendered (a Python int)."""
    cfg = cfg or C.RasterConfig()
    info: dict = {}
    image, t_final, radii, visibility = _Rasterize.apply(
        ndc, conic, colors, opacity, depth.to(torch.float32), valid, bg,
        width, height, full_height or height, row0, None, cfg, info)
    return {"render": image, "final_T": t_final, "radii": radii,
            "visibility": visibility, "num_rendered": info["num_rendered"]}


def rasterize_batched(ndc: torch.Tensor, conic: torch.Tensor, colors: torch.Tensor,
                      opacity: torch.Tensor, depth: torch.Tensor, valid: torch.Tensor,
                      bg: torch.Tensor, width: int, height: int,
                      cfg: C.RasterConfig | None = None) -> dict[str, Any]:
    """Batched-camera splatting (the JAX package's ``rasterize_batched``):
    every input gains a leading camera axis B, and all B cameras go through
    one binning, one launch of each compositing kernel over a virtual grid
    of B images (camera b's tile rows shifted by b * gy; the kernels take a
    tile's row within its image as (tile // gx) % gy) and one segment
    reduction.  Each camera's pixels are its own ``rasterize`` call's bit
    for bit; its gradients differ from that call's only by the float64
    scan's rounding over the longer stream.

    Inputs: ndc [B, P, 3], conic [B, P, 3], colors [B, P, 10], opacity
    [B, P, 1], depth [B, P], valid [B, P], bg [10] (its gradient sums over
    cameras).  Returns render [B, 10, H, W], final_T [B, H, W], radii
    [B, P] int32, visibility [B, P] bool, num_rendered (the instances over
    every camera, a Python int) and num_rendered_bound (B times the largest
    camera's count)."""
    cfg = cfg or C.RasterConfig()
    b, p = ndc.shape[:2]
    flat = lambda x: x.reshape((b * p,) + tuple(x.shape[2:]))
    info: dict = {}
    image, t_final, radii, visibility = _Rasterize.apply(
        flat(ndc), flat(conic), flat(colors), flat(opacity), flat(depth.to(torch.float32)),
        flat(valid), bg, width, height, height, 0, b, cfg, info)
    return {"render": image, "final_T": t_final, "radii": radii,
            "visibility": visibility, "num_rendered": info["num_rendered"],
            "num_rendered_bound": info["num_rendered_bound"]}
