"""Parity of the port's core maths with the JAX package: quaternions, SH,
Lie maps, projection, camera_geom, kNN, losses and SSIM.  The same seeded
numpy inputs go through both; forward values and gradients (torch autograd
against jax.grad of the same weighted sum) must agree within rtol 1e-5 /
atol 1e-6 (float32, the same formulas)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.ops import knn as j_knn
from gaussianhaircut_tpu.ops import lie as j_lie
from gaussianhaircut_tpu.ops import losses as j_losses
from gaussianhaircut_tpu.ops import projection as j_proj
from gaussianhaircut_tpu.ops import quaternion as j_quat
from gaussianhaircut_tpu.ops import sh as j_sh
from gaussianhaircut_tpu.ops import ssim as j_ssim
from gaussianhaircut_tpu.scene import cameras as j_cams
from gaussianhaircut_torch.ops import knn as t_knn
from gaussianhaircut_torch.ops import lie as t_lie
from gaussianhaircut_torch.ops import losses as t_losses
from gaussianhaircut_torch.ops import projection as t_proj
from gaussianhaircut_torch.ops import quaternion as t_quat
from gaussianhaircut_torch.ops import sh as t_sh
from gaussianhaircut_torch.ops import ssim as t_ssim
from gaussianhaircut_torch.scene import cameras as t_cams

TOL = dict(rtol=1e-5, atol=1e-6)


def _rng():
    return np.random.default_rng(11)


def _check(jfn, tfn, inputs, grad=True, tol=TOL, grad_atol_of_max=False):
    """Forward values and the gradient of sum(out * w) for every input.
    With ``grad_atol_of_max`` the gradients' absolute tolerance is taken
    relative to their largest entry."""
    jout = np.asarray(jfn(*(jnp.asarray(x) for x in inputs)))
    tin = [torch.tensor(x, requires_grad=grad) for x in inputs]
    tout = tfn(*tin)
    np.testing.assert_allclose(tout.detach().numpy(), jout, **tol)
    if not grad:
        return
    w = np.asarray(_rng().normal(size=jout.shape), np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(inputs))))(
        *(jnp.asarray(x) for x in inputs))
    tg = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), tin)
    for i, (a, b) in enumerate(zip(tg, jg)):
        b = np.asarray(b)
        atol = tol["atol"] * max(1.0, np.abs(b).max()) if grad_atol_of_max else tol["atol"]
        np.testing.assert_allclose(a.numpy(), b, rtol=tol["rtol"], atol=atol,
                                   err_msg=f"grad {i}")


def _camera():
    """A camera 2.5 units from the origin looking at it, 64x48, fov 50 deg:
    (colmap w2c [4, 4], fovx, fovy)."""
    center = np.array([1.5, 0.3, 2.0])
    fwd = -center / np.linalg.norm(center)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 0)
    w2c[:3, 3] = -w2c[:3, :3] @ center
    return w2c, np.float32(math.radians(50)), np.float32(math.radians(40))


def _geoms(res=None):
    """(jax CameraGeom, torch CameraGeom) of _camera() with residuals."""
    w2c, fx, fy = _camera()
    rng = _rng()
    rot = (rng.normal(size=3) * 0.01).astype(np.float32) if res is None else res[0]
    tr = (rng.normal(size=3) * 0.01).astype(np.float32) if res is None else res[1]
    fov = (rng.normal(size=2) * 0.01).astype(np.float32) if res is None else res[2]
    jr = j_cams.CameraResiduals(jnp.asarray(rot), jnp.asarray(tr), jnp.asarray(fov))
    tr_ = t_cams.CameraResiduals(torch.tensor(rot), torch.tensor(tr), torch.tensor(fov))
    jg = j_cams.camera_geom(jnp.asarray(w2c), jnp.asarray(fx), jnp.asarray(fy), 64, 48, jr)
    tg = t_cams.camera_geom(torch.tensor(w2c), torch.tensor(fx), torch.tensor(fy), 64, 48, tr_)
    return jg, tg


def _points(rng, n=32):
    return (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)


def _rotmats(rng, n=32):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return np.asarray(j_quat.build_rotation(jnp.asarray(q)))


def _scales(rng, n=32):
    return np.exp(rng.uniform(-4, -1, size=(n, 3))).astype(np.float32)


def _dirs(rng, n=32):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


CASES = {
    "normalize": (j_quat.normalize, t_quat.normalize,
                  lambda rng: [rng.normal(size=(16, 3)).astype(np.float32)]),
    "build_rotation": (j_quat.build_rotation, t_quat.build_rotation,
                       lambda rng: [rng.normal(size=(16, 4)).astype(np.float32)]),
    "sh_basis_deg3": (lambda d: j_sh.sh_basis(3, d), lambda d: t_sh.sh_basis(3, d),
                      lambda rng: [_dirs(rng)]),
    "sh_basis_deg4": (lambda d: j_sh.sh_basis(4, d), lambda d: t_sh.sh_basis(4, d),
                      lambda rng: [_dirs(rng)]),
    "eval_sh": (lambda s, d: j_sh.eval_sh(3, s, d), lambda s, d: t_sh.eval_sh(3, s, d),
                lambda rng: [rng.normal(size=(32, 16, 3)).astype(np.float32), _dirs(rng)]),
    "rgb2sh_sh2rgb": (lambda x: j_sh.sh2rgb(j_sh.rgb2sh(x)),
                      lambda x: t_sh.sh2rgb(t_sh.rgb2sh(x)),
                      lambda rng: [rng.uniform(size=(8, 3)).astype(np.float32)]),
    "skew": (j_lie.skew, t_lie.skew, lambda rng: [rng.normal(size=(8, 3)).astype(np.float32)]),
    "so3_to_SO3": (j_lie.so3_to_SO3, t_lie.so3_to_SO3,
                   lambda rng: [(rng.normal(size=(8, 3)) * 0.3).astype(np.float32)]),
    "se3_to_SE3": (j_lie.se3_to_SE3, t_lie.se3_to_SE3,
                   lambda rng: [(rng.normal(size=(8, 6)) * 0.3).astype(np.float32)]),
    "se3_to_SE3_at_zero": (j_lie.se3_to_SE3, t_lie.se3_to_SE3,
                           lambda rng: [np.zeros((2, 6), np.float32)]),
    "ortho6d_to_rotation": (j_lie.ortho6d_to_rotation, t_lie.ortho6d_to_rotation,
                            lambda rng: [rng.normal(size=(8, 6)).astype(np.float32)]),
    "covariance_3d": (j_proj.covariance_3d, t_proj.covariance_3d,
                      lambda rng: [_scales(rng), _rotmats(rng)]),
    "l1_loss_masked": (lambda p, g, m: j_losses.l1_loss(p, g, mask=m),
                       lambda p, g, m: t_losses.l1_loss(p, g, mask=m),
                       lambda rng: [rng.uniform(size=(3, 12, 10)).astype(np.float32)
                                for _ in range(2)]
                       + [rng.uniform(size=(1, 12, 10)).astype(np.float32)]),
    "or_loss": (lambda p, g, c, w, m: j_losses.or_loss(p, g, confs=c, weight=w, mask=m),
                lambda p, g, c, w, m: t_losses.or_loss(p, g, confs=c, weight=w, mask=m),
                lambda rng: [rng.uniform(size=(1, 12, 10)).astype(np.float32)
                         for _ in range(2)]
                + [rng.uniform(0.5, 2.0, size=(1, 12, 10)).astype(np.float32)]
                + [rng.uniform(size=(1, 12, 10)).astype(np.float32) for _ in range(2)]),
    "psnr": (j_losses.psnr, t_losses.psnr,
             lambda rng: [rng.uniform(size=(3, 12, 10)).astype(np.float32) for _ in range(2)]),
    "ssim": (j_ssim.ssim, t_ssim.ssim,
             lambda rng: [rng.uniform(size=(3, 24, 20)).astype(np.float32),
                      rng.uniform(size=(3, 24, 20)).astype(np.float32) * 0.5 + 0.2]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    jfn, tfn, make = CASES[name]
    _check(jfn, tfn, make(_rng()))


def _proj_case(fname):
    """(jax fn, torch fn) of a projection function closing over the camera."""
    jg, tg = _geoms()
    table = {
        "to_view": (lambda x: j_proj.to_view(x, jg.viewmatrix),
                    lambda x: t_proj.to_view(x, tg.viewmatrix)),
        "project_ndc": (lambda x: j_proj.project_ndc(x, jg.projmatrix),
                        lambda x: t_proj.project_ndc(x, tg.projmatrix)),
        "depths": (lambda x: j_proj.depths(x, jg), lambda x: t_proj.depths(x, tg)),
        "covariance_2d": (lambda x, s, r: j_proj.covariance_2d(x, j_proj.covariance_3d(s, r), jg),
                          lambda x, s, r: t_proj.covariance_2d(x, t_proj.covariance_3d(s, r), tg)),
        "conic": (lambda x, s, r: j_proj.conic_from_cov2d(
                      j_proj.covariance_2d(x, j_proj.covariance_3d(s, r), jg)),
                  lambda x, s, r: t_proj.conic_from_cov2d(
                      t_proj.covariance_2d(x, t_proj.covariance_3d(s, r), tg))),
        "direction_2d": (lambda x, s, r: j_proj.direction_2d(x, s, r, jg),
                         lambda x, s, r: t_proj.direction_2d(x, s, r, tg)),
    }
    return table[fname]


@pytest.mark.parametrize("fname", ["to_view", "project_ndc", "depths",
                                   "covariance_2d", "conic", "direction_2d"])
def test_projection_matches_jax(fname):
    jfn, tfn = _proj_case(fname)
    rng = _rng()
    inputs = [_points(rng)] if fname in ("to_view", "project_ndc", "depths") \
        else [_points(rng), _scales(rng), _rotmats(rng)]
    # the gradients of the EWA covariance and of its 2x2 inverse w.r.t. the
    # scales cancel between terms: entries far below the largest carry the
    # largest one's rounding (the conic: 4e-4 relative on a 5e-2 entry beside
    # 4e1 ones), so their absolute tolerance is 1e-6 of the largest entry
    _check(jfn, tfn, inputs, grad_atol_of_max=fname in ("covariance_2d", "conic"))


@pytest.mark.parametrize("use_barf", [True, False])
def test_camera_geom_matches_jax(use_barf):
    """camera_geom: forward bundle and gradients w.r.t. the residuals."""
    w2c, fx, fy = _camera()
    rng = _rng()
    rot = ((rng.normal(size=3) * 0.01) if use_barf
           else np.array([1, 0, 0, 0, 1, 0]) + rng.normal(size=6) * 0.01).astype(np.float32)
    tr = (rng.normal(size=3) * 0.01).astype(np.float32)
    fov = (rng.normal(size=2) * 0.01).astype(np.float32)
    w = rng.normal(size=(4, 4)).astype(np.float32)

    def jfn(rot, tr, fov):
        g = j_cams.camera_geom(jnp.asarray(w2c), jnp.asarray(fx), jnp.asarray(fy), 64, 48,
                               j_cams.CameraResiduals(rot, tr, fov), use_barf=use_barf)
        return jnp.sum(g.projmatrix * w) + jnp.sum(g.campos) + g.tan_fovx, g

    (jv, jg), jgr = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(rot), jnp.asarray(tr), jnp.asarray(fov))
    tin = [torch.tensor(x, requires_grad=True) for x in (rot, tr, fov)]
    tg = t_cams.camera_geom(torch.tensor(w2c), torch.tensor(fx), torch.tensor(fy), 64, 48,
                            t_cams.CameraResiduals(*tin), use_barf=use_barf)
    tv = torch.sum(tg.projmatrix * torch.from_numpy(w)) + torch.sum(tg.campos) + tg.tan_fovx
    for name in ("viewmatrix", "projmatrix", "campos", "tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(getattr(tg, name).detach().numpy(),
                                   np.asarray(getattr(jg, name)), err_msg=name, **TOL)
    np.testing.assert_allclose(float(tv.detach()), float(jv), **TOL)
    for a, b in zip(torch.autograd.grad(tv, tin), jgr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_knn_matches_jax():
    pts = _points(_rng(), 300)
    ref = np.asarray(j_knn.mean_knn_sq_dist(jnp.asarray(pts), block_size=128,
                                            chunk_size=256))
    ours = t_knn.mean_knn_sq_dist(torch.from_numpy(pts), block_size=128, chunk_size=256)
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)
