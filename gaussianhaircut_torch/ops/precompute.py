"""The precompute on the card: each Gaussian's compositing inputs from its
fields and one camera, in one forward and one backward kernel
(``gaussianhaircut_torch/csrc/precompute.cu``).

``precompute_cuda`` is a ``torch.autograd.Function`` over CUDA tensors:
its forward is one launch of ``precompute_fwd`` (after one concatenation of
the camera into 37 floats), which writes ndc [P, 3], conic [P, 3],
colors [P, 10] and depth [P]; its backward is one launch of
``precompute_bwd``, which recomputes the forward's intermediates from the
inputs (autograd saves only the inputs) and writes the gradients of xyz,
features, scaling, rotation_matrix, label and orient_conf, plus, where a
camera tensor needs a gradient, one launch of ``precompute_cam_reduce``,
which sums the blocks' partial camera gradients in block order in float64.
The viewspace port's gradient is the NDC's, passed through.  No float
atomics: two backward runs agree bit for bit.

What it computes is ``renderer.precompute_plain``, the composition the CPU
runs, in float32 with the same clamps and eps terms, rounded as that
composition is on the card: ndc, conic and depth, which the binning and the
compositing kernels decide on, equal its bit for bit; the colours and the
gradients differ from autograd's by rounding.  SH degrees 0-3 are taken;
another raises.  Each launch adds one to ``cuda_core.launches`` under its C
entry point.
"""
from __future__ import annotations

import ctypes

import torch

from gaussianhaircut_torch.ops.rasterize import cuda_core

# csrc/precompute.cu's constants, checked against the library at first use:
# threads per block (one Gaussian each), camera values summed per block,
# floats of the packed camera, SH rows a Gaussian may store
THREADS = 128
CAM_VALUES = 33
CAM_FLOATS = 37
MAX_SH_ROWS = 25
MAX_DEGREE = 3


def check_degree(deg: int) -> None:
    if not 0 <= deg <= MAX_DEGREE:
        raise ValueError(f"precompute: the kernel takes SH degrees 0-{MAX_DEGREE}, "
                         f"not SH degree {deg}")


_layout_checked = False


def _check_layout() -> None:
    global _layout_checked
    if _layout_checked:
        return
    fn = cuda_core.library("precompute").precompute_layout
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 4)()
    fn(out)
    want = (THREADS, CAM_VALUES, CAM_FLOATS, MAX_SH_ROWS)
    if tuple(out) != want:
        raise RuntimeError(f"csrc/precompute.cu's layout {tuple(out)} is not the wrapper's "
                           f"{want} (threads, camera values, camera floats, SH rows)")
    _layout_checked = True


def _f32(what: str, t: torch.Tensor, device, shape) -> torch.Tensor:
    """``t`` checked: float32, on ``device``, of ``shape`` (or of one element
    where ``shape`` is None)."""
    if (t.dtype is not torch.float32 or t.device != device
            or (t.numel() != 1 if shape is None else tuple(t.shape) != tuple(shape))):
        raise ValueError(f"precompute: {what} is {t.dtype} {tuple(t.shape)} on {t.device}; "
                         f"expected float32 {'of one element' if shape is None else tuple(shape)}"
                         f" on {device}")
    return t


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


class _Precompute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xyz, features, scaling, rot, label, orient_conf, viewspace, use_direction,
                viewmatrix, projmatrix, campos, tan_fovx, tan_fovy, deg, mod, width, height):
        ctx.set_materialize_grads(False)
        n, rows = features.shape[:2]
        dev = xyz.device
        cam = torch.cat([viewmatrix.reshape(16), projmatrix.reshape(16), campos.reshape(3),
                         tan_fovx.reshape(1), tan_fovy.reshape(1)])
        ndc = torch.empty((n, 3), dtype=torch.float32, device=dev)
        conic = torch.empty((n, 3), dtype=torch.float32, device=dev)
        colors = torch.empty((n, 10), dtype=torch.float32, device=dev)
        depth = torch.empty((n,), dtype=torch.float32, device=dev)
        if n:
            cuda_core.launch("precompute_fwd", xyz.data_ptr(), features.data_ptr(),
                             scaling.data_ptr(), rot.data_ptr(), label.data_ptr(),
                             orient_conf.data_ptr(), viewspace.data_ptr(), _ptr(use_direction),
                             cam.data_ptr(), ndc.data_ptr(), conic.data_ptr(),
                             colors.data_ptr(), depth.data_ptr(), n, rows, deg, width,
                             height, mod, torch.cuda.current_stream(dev).cuda_stream)
        ctx.save_for_backward(xyz, features, scaling, rot, use_direction, cam)
        ctx.meta = (deg, mod, width, height,
                    [t.shape for t in (viewmatrix, projmatrix, campos, tan_fovx, tan_fovy)])
        return ndc, conic, colors, depth

    @staticmethod
    def backward(ctx, g_ndc, g_conic, g_colors, g_depth):
        xyz, features, scaling, rot, use_direction, cam = ctx.saved_tensors
        deg, mod, width, height, cam_shapes = ctx.meta
        need = ctx.needs_input_grad
        if need[7]:
            raise ValueError("precompute: the kernel gives use_direction no gradient")
        n, rows = features.shape[:2]
        dev = xyz.device
        grads = [g if g is None else g.contiguous() for g in (g_ndc, g_conic, g_colors,
                                                              g_depth)]
        out = [torch.empty_like(t) if need[i] else None
               for i, t in enumerate((xyz, features, scaling, rot))]
        g_label = torch.empty((n, 1), dtype=torch.float32, device=dev) if need[4] else None
        g_oc = torch.empty((n, 1), dtype=torch.float32, device=dev) if need[5] else None
        cam_grad = any(need[8:13])
        blocks = -(-n // THREADS)
        part = (torch.empty((blocks, CAM_VALUES), dtype=torch.float64, device=dev)
                if cam_grad else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if n:
            _check_layout()
            cuda_core.launch("precompute_bwd", xyz.data_ptr(), features.data_ptr(),
                             scaling.data_ptr(), rot.data_ptr(), _ptr(use_direction),
                             cam.data_ptr(), *map(_ptr, grads),
                             *map(_ptr, out), _ptr(g_label), _ptr(g_oc), _ptr(part), n, rows,
                             deg, width, height, mod, stream)
        g_cam = [None] * 5
        if cam_grad:
            flat = torch.empty(CAM_FLOATS, dtype=torch.float32, device=dev)
            cuda_core.launch("precompute_cam_reduce", _ptr(part), blocks, flat.data_ptr(),
                             stream)
            cuts = (0, 16, 32, 35, 36, 37)
            g_cam = [flat[a:b].view(shape) if need[8 + k] else None
                     for k, (a, b, shape) in enumerate(zip(cuts, cuts[1:], cam_shapes))]
        g_vs = g_ndc if need[6] else None
        return (*out, g_label, g_oc, g_vs, None, *g_cam, None, None, None, None)


def precompute_cuda(xyz, features, scaling, rotation_matrix, label, orient_conf, viewspace,
                    use_direction, cam, active_sh_degree: int, scaling_modifier: float = 1.0):
    """-> (ndc [P, 3], conic [P, 3], colors [P, 10], depth [P]) of CUDA
    fields at ``cam`` (a ``CameraGeom`` whose tensors lie on the same
    device), differentiable in every field but ``use_direction`` and in the
    camera's tensors.  Every field and camera tensor is checked (float32,
    its shape, the device), then the device itself; ``features`` may store
    more SH rows than the degree reads."""
    check_degree(active_sh_degree)
    dev = xyz.device
    n = xyz.shape[0]
    rows = features.shape[1] if features.dim() == 3 else -1
    if not (active_sh_degree + 1) ** 2 <= rows <= MAX_SH_ROWS:
        raise ValueError(f"precompute: features {tuple(features.shape)} hold no "
                         f"[{n}, K, 3] with {(active_sh_degree + 1) ** 2} <= K <= "
                         f"{MAX_SH_ROWS} at SH degree {active_sh_degree}")
    # the per-Gaussian fields in rows (a copy, through autograd, where they
    # are not); the camera's tensors as they are, packed by the forward
    args = [_f32(name, t, dev, shape).contiguous() for name, t, shape in (
        ("xyz", xyz, (n, 3)), ("features", features, (n, rows, 3)),
        ("scaling", scaling, (n, 3)), ("rotation_matrix", rotation_matrix, (n, 3, 3)),
        ("label", label, (n, 1)), ("orient_conf", orient_conf, (n, 1)),
        ("viewspace", viewspace, (n, 3)))]
    args.append(None if use_direction is None
                else _f32("use_direction", use_direction, dev, (n,)).contiguous())
    cam_args = [_f32(name, t if isinstance(t, torch.Tensor)
                     else torch.tensor(t, dtype=torch.float32, device=dev), dev, shape)
                for name, t, shape in (("viewmatrix", cam.viewmatrix, (4, 4)),
                                       ("projmatrix", cam.projmatrix, (4, 4)),
                                       ("campos", cam.campos, (3,)),
                                       ("tan_fovx", cam.tan_fovx, None),
                                       ("tan_fovy", cam.tan_fovy, None))]
    if not xyz.is_cuda:
        raise ValueError(f"precompute_cuda: expected CUDA fields, got {dev}")
    return _Precompute.apply(*args, *cam_args, active_sh_degree, float(scaling_modifier),
                             int(cam.width), int(cam.height))
