"""The reference stage-1 training step (GaussianHaircut's
``train_gaussians.py:120-181`` on 3DGS's ``gaussian_model.py``).

One step on camera ``idx``: activate the parameters, apply the view's BARF
pose and field-of-view residuals, render the 10 channels, take the loss

  0.8 L1(render | body) + 0.2 (1 - SSIM(render * body, gt * body))
  + lambda_dmask L1(mask) + lambda_dorient OR(angle | conf, gt conf, hair)

(the weights from the configuration), its gradient, the densify statistics
of the visible Gaussians, Adam on every parameter when every gradient is
finite (the viewspace port excepted, whose lr is 0), and Adam on the drawn
camera's residual row while the step is below ``iterations_cam``.

The state is a dict: ``params``, ``mu``, ``nu`` and ``aux`` (dicts of
tensors by leaf), ``alive``, ``cam`` / ``cam_mu`` / ``cam_nu`` (the residual
rows and their moments), ``cam_count`` (per row), ``count`` and ``step``
(ints), ``spatial_lr_scale``.
"""
from __future__ import annotations

import torch

from reference import geometry as geo
from reference import losses as L
from reference import optim
from reference.render import Fields, background, render

PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "label",
          "orient_conf", "viewspace")
CAM = ("rotation", "translation", "fov")


def fields(p: dict, alive) -> Fields:
    return Fields(xyz=p["xyz"], features=torch.cat([p["features_dc"], p["features_rest"]], 1),
                  scaling=torch.exp(p["scaling"]), rotation=geo.build_rotation(p["rotation"]),
                  opacity=torch.sigmoid(p["opacity"]), label=torch.sigmoid(p["label"]),
                  orient_conf=torch.exp(torch.clamp(p["orient_conf"], -30.0, 30.0)),
                  valid=alive, viewspace=p["viewspace"])


def view_camera(cams: dict, cam_res: dict, idx: int, cfg: dict) -> geo.Camera:
    rot = trans = fov = None
    if cfg["trainable_cameras"]:
        rot, trans = cam_res["rotation"][idx], cam_res["translation"][idx]
    if cfg["trainable_intrinsics"]:
        fov = cam_res["fov"][idx]
    return geo.camera(cams["colmap_transform"][idx], cams["fovx"][idx], cams["fovy"][idx],
                      cfg["width"], cfg["height"], rot, trans, fov)


def losses(out: dict, gt: dict, idx: int, opt: dict):
    image, mask = gt["image"][idx], gt["mask"][idx]
    angle, conf = gt["orient_angle"][idx], gt["orient_conf"][idx]
    render_, omask = out["render"], out["mask"]
    oangle, oconf = out["orient_angle"], out["orient_conf"]
    body, hair = mask[1:], mask[:1]
    ll1 = L.l1(render_, image, body)
    lssim = 1.0 - L.ssim(render_ * body, image * body)
    lmask = L.l1(omask, mask)
    lor = L.zero_nan(L.orientation(oangle, angle, oconf, torch.ones_like(hair) * conf, hair))
    return (ll1 * opt["lambda_dl1"] + lssim * opt["lambda_dssim"]
            + lmask * opt["lambda_dmask"] + lor * opt["lambda_dorient"])


def lrs(opt: dict, scale: float, step: int) -> tuple[dict, dict]:
    xyz = optim.expon_lr(step, opt["position_lr_init"] * scale, opt["position_lr_final"] * scale,
                         opt["position_lr_max_steps"])
    p = {"xyz": xyz, "features_dc": opt["feature_lr"], "features_rest": opt["feature_lr"] / 20.0,
         "scaling": opt["scaling_lr"], "rotation": opt["rotation_lr"],
         "opacity": opt["opacity_lr"], "label": opt["label_lr"],
         "orient_conf": opt["orient_conf_lr"] if opt["train_orient_conf"] else 0.0,
         "viewspace": 0.0}
    trans = optim.expon_lr(step, opt["cam_translation_lr_init"] * scale,
                           opt["cam_translation_lr_final"] * scale, opt["cam_lr_max_steps"])
    c = {"rotation": opt["cam_rotation_lr"], "translation": trans, "fov": opt["cam_fov_lr"]}
    return p, c


def step(state: dict, cams: dict, gt: dict, idx: int, cfg: dict) -> tuple:
    """-> (new state, loss as a float)."""
    opt = cfg["optimization"]
    params = {k: v.detach().requires_grad_() for k, v in state["params"].items()}
    cam_res = {k: v.detach().requires_grad_() for k, v in state["cam"].items()}
    out = render(fields(params, state["alive"]), cfg["active_sh_degree"],
                 view_camera(cams, cam_res, idx, cfg), background(cfg["white_background"],
                                                                  params["xyz"].device))
    total = losses(out, gt, idx, opt)
    leaves = [params[k] for k in PARAMS] + [cam_res[k] for k in CAM]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    gp = dict(zip(PARAMS, grads[:len(PARAMS)]))
    gc = dict(zip(CAM, grads[len(PARAMS):]))
    new = dict(state)
    with torch.no_grad():
        vs = gp["viewspace"]
        gn = torch.linalg.norm(torch.where(torch.isfinite(vs), vs, torch.zeros_like(vs))[:, :2],
                               dim=-1)
        vis = out["visible"]
        aux = state["aux"]
        new["aux"] = {
            "max_radii2d": torch.where(vis, torch.maximum(aux["max_radii2d"], out["radii"]),
                                       aux["max_radii2d"]),
            "xyz_grad_accum": aux["xyz_grad_accum"] + torch.where(vis, gn, torch.zeros_like(gn)),
            "denom": aux["denom"] + vis.to(torch.float32)}
        plr, clr = lrs(opt, state["spatial_lr_scale"], state["step"])
        if optim.finite({k: g for k, g in gp.items() if k != "viewspace"}):
            p, m, v = optim.adam(state["params"], gp, state["mu"], state["nu"],
                                 state["count"] + 1, plr)
            new.update(params=p, mu=m, nu=v, count=state["count"] + 1)
        train_cam = cfg["trainable_cameras"] or cfg["trainable_intrinsics"]
        if train_cam and optim.finite(gc) and state["step"] < opt["iterations_cam"]:
            count = state["cam_count"][idx] + 1
            cam, cmu, cnu = ({k: v.clone() for k, v in state[n].items()}
                             for n in ("cam", "cam_mu", "cam_nu"))
            rows = {k: v[idx] for k, v in state["cam"].items()}
            p, m, v = optim.adam(rows, {k: g[idx] for k, g in gc.items()},
                                 {k: v[idx] for k, v in state["cam_mu"].items()},
                                 {k: v[idx] for k, v in state["cam_nu"].items()}, count, clr)
            for k in CAM:
                cam[k][idx], cmu[k][idx], cnu[k][idx] = p[k], m[k], v[k]
            cam_count = list(state["cam_count"])
            cam_count[idx] = count
            new.update(cam=cam, cam_mu=cmu, cam_nu=cnu, cam_count=cam_count)
    new["step"] = state["step"] + 1
    return new, float(total.detach())
