"""Camera and per-Gaussian geometry of the reference: the BARF camera
residual, the projection matrices, the EWA covariance projection, the NDC
means, the 2D strand direction and the spherical harmonics (3DGS and
GaussianHaircut's ``gaussian_model.py:143-393``, ``cameras.py:21-196``,
``graphics_utils.py:51-72``, ``sh_utils.py``; a frozen copy of the port's
plain code).  Row-vector 4x4 transforms: x_view = x @ M[:3, :3] + M[3, :3].
"""
from __future__ import annotations

import dataclasses
import math

import torch

from reference import precision as prec

ZNEAR, ZFAR = 0.01, 100.0
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@dataclasses.dataclass
class Camera:
    viewmatrix: torch.Tensor      # [4, 4] row-vector world -> view
    projmatrix: torch.Tensor      # [4, 4] row-vector world -> NDC
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor
    width: int
    height: int
    campos: torch.Tensor          # [3]


# ------------------------------------------------------------ rotations --

def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v / torch.sqrt(torch.clamp(n2, min=eps * eps))


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> the 3DGS rotation matrix, whose ROWS are the
    Gaussian's principal axes."""
    q = normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + r * z), 2 * (x * z - r * y)], -1)
    row1 = torch.stack([2 * (x * y - r * z), 1 - 2 * (x * x + z * z), 2 * (y * z + r * x)], -1)
    row2 = torch.stack([2 * (x * z + r * y), 2 * (y * z - r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def parallel_transport(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unnormalized quaternion [1 + a.b, a x b] turning direction a onto b."""
    a, b = normalize(a), normalize(b)
    s = 1.0 + torch.sum(a * b, dim=-1, keepdim=True)
    return torch.cat([s, torch.linalg.cross(a, b, dim=-1)], dim=-1)


def _taylor(x2: torch.Tensor, kind: str, terms: int = 10) -> torch.Tensor:
    """sin(x)/x (A), (1 - cos x)/x^2 (B), (x - sin x)/x^3 (C) as series in x^2."""
    ans = torch.zeros_like(x2)
    denom, pw = 1.0, torch.ones_like(x2)
    for i in range(terms + 1):
        if kind == "A":
            if i > 0:
                denom *= (2 * i) * (2 * i + 1)
        elif kind == "B":
            denom *= (2 * i + 1) * (2 * i + 2)
        else:
            denom *= (2 * i + 2) * (2 * i + 3)
        ans = ans + ((-1) ** i) * pw / denom
        pw = pw * x2
    return ans


def _skew(w: torch.Tensor) -> torch.Tensor:
    o = torch.zeros_like(w[0])
    return torch.stack([torch.stack([o, -w[2], w[1]]), torch.stack([w[2], o, -w[0]]),
                        torch.stack([-w[1], w[0], o])])


def se3_exp(wu: torch.Tensor) -> torch.Tensor:
    """(w | u) [6] -> [3, 4] pose [R | V u] (BARF, camera_opt_utils.py)."""
    w, u = wu[:3], wu[3:]
    wx = _skew(w)
    wx2 = prec.matmul(wx, wx)
    th2 = torch.sum(w * w)
    a, b, c = (_taylor(th2, k) for k in "ABC")
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    rot = eye + a * wx + b * wx2
    v = eye + b * wx + c * wx2
    return torch.cat([rot, prec.matmul(v, u[:, None])], dim=1)


# --------------------------------------------------------------- cameras --

def projection_matrix(fovx, fovy) -> torch.Tensor:
    """Column-vector perspective matrix with z in [0, 1]."""
    tx, ty = torch.tan(fovx * 0.5), torch.tan(fovy * 0.5)
    z, one = torch.zeros_like(tx), torch.ones_like(tx)
    return torch.stack([
        torch.stack([1.0 / tx, z, z, z]),
        torch.stack([z, 1.0 / ty, z, z]),
        torch.stack([z, z, ZFAR / (ZFAR - ZNEAR) * one, -(ZFAR * ZNEAR) / (ZFAR - ZNEAR) * one]),
        torch.stack([z, z, one, z]),
    ])


def camera(colmap_transform, fovx, fovy, width: int, height: int,
           rot_res=None, trans_res=None, fov_res=None) -> Camera:
    """The camera of a view: the pose times the BARF residual exp(rot | trans)
    and the fields of view plus their residual, when given."""
    if fov_res is not None:
        fovx, fovy = fovx + fov_res[0], fovy + fov_res[1]
    w2c = colmap_transform
    if rot_res is not None:
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=w2c.dtype, device=w2c.device)
        res = torch.cat([se3_exp(torch.cat([rot_res, trans_res])), bottom], 0)
        w2c = prec.matmul(w2c, res)
    view = w2c.T
    proj = prec.matmul(view, projection_matrix(fovx, fovy).T)
    campos = torch.linalg.inv(view)[3, :3]
    return Camera(view, proj, torch.tan(fovx * 0.5), torch.tan(fovy * 0.5), width, height,
                  campos)


# ------------------------------------------------------------ projection --

def to_view(xyz, view):
    return prec.matmul(xyz, view[:3, :3]) + view[3, :3]


def jacobian_t(xyz, cam: Camera) -> torch.Tensor:
    """T = W J [P, 3, 3] of the EWA splatting, with the 1.3 tan(fov) clamp."""
    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    t = to_view(xyz, cam.viewmatrix)
    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz
    zero = torch.zeros_like(tz)
    col0 = torch.stack([fx / tz, zero, -(fx * tx) / (tz * tz)], -1)
    col1 = torch.stack([zero, fy / tz, -(fy * ty) / (tz * tz)], -1)
    jac = torch.stack([col0, col1, torch.stack([zero, zero, zero], -1)], -1)
    return prec.matmul(cam.viewmatrix[None, :3, :3], jac)


def splat_geometry(xyz, scaling, rot, cam: Camera):
    """-> (ndc [P, 3], cov2d [P, 3], conic [P, 3], depth [P], dir2d [P, 3]):
    the EWA covariance with the 0.3 pixel dilation, packed (c00, c01, c11),
    its conic with the 1e-12 determinant epsilon, the NDC means with the
    1e-7 w epsilon, the view depth, and the longest axis projected through T
    (the strand direction in the image)."""
    m = scaling[:, :, None] * rot
    cov3 = prec.matmul(m.transpose(1, 2), m)
    t = jacobian_t(xyz, cam)
    cov2 = prec.matmul(prec.matmul(t.transpose(1, 2), cov3), t)
    c00, c01, c11 = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = c00 * c11 - c01 ** 2
    inv = 1.0 / (det + 1e-12)
    conic = torch.stack([c11, -c01, c00], -1) * inv[:, None]
    hom = prec.matmul(xyz, cam.projmatrix[:3, :]) + cam.projmatrix[3, :]
    ndc = hom[:, :3] * (1.0 / (hom[:, 3:4] + 1e-7))
    depth = to_view(xyz, cam.viewmatrix)[:, 2]
    axis = torch.nn.functional.one_hot(torch.argmax(scaling, -1), 3).to(scaling.dtype)
    d = prec.einsum("pk,pkj->pj", axis, rot) * torch.sum(scaling * axis, -1, keepdim=True)
    dir2d = prec.einsum("pi,pij->pj", d, t)
    return ndc, torch.stack([c00, c01, c11], -1), conic, depth, dir2d


def sh_colour(features, dirs, degree: int) -> torch.Tensor:
    """RGB of SH ``features`` [P, K, 3] seen along unit ``dirs``, +0.5, >= 0."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    basis = [torch.full_like(x, SH_C0)]
    if degree > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
                  SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if degree > 2:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    k = len(basis)
    rgb = prec.einsum("pk,pkc->pc", torch.stack(basis, -1), features[:, :k])
    return torch.clamp(rgb + 0.5, min=0.0)


def rgb2sh(rgb):
    return (rgb - 0.5) / SH_C0


def inverse_sigmoid(x: float) -> float:
    return math.log(x / (1 - x))
