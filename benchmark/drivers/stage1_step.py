"""Driver of ``gaussianhaircut_torch.train.stage1.train_step``: the stage-1
step that ``train()`` calls on one camera per iteration, in the loop's
camera order, without densification or opacity resets.

Inputs, all from the seed: the configuration's Gaussian population, the
ring of views with their ground truth, the camera order.  The port's state
is its own ``TrainState`` around those tensors (fresh optimizer and camera
residuals); the reference gets the same tensors.
"""
from __future__ import annotations

import torch

from benchlib import counts, inputs
from benchlib.compare import Readings
from reference import render as R
from reference import stage1 as ref

PARAM_LEAVES = ref.PARAMS
CAM_LEAVES = ref.CAM
AUX_LEAVES = ("max_radii2d", "xyz_grad_accum", "denom")
CHECKED_STEPS = 3


class Driver:
    stage = "stage1"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.views_per_step = 1
        count = traffic["gaussians"]
        self.init = inputs.gaussians(inputs.generator(seed, "gaussians", device), count,
                                     cfg["gaussians"])
        self.cams = inputs.cameras(cfg, device)
        self.gt = inputs.ground_truth(inputs.generator(seed, "ground_truth", device),
                                      cfg["views"], cfg["width"], cfg["height"])
        self.order = inputs.CameraOrder(cfg["views"], seed)
        self.checked_views: list[int] = []

    # ------------------------------------------------------------ the port --
    def _program(self):
        from gaussianhaircut_torch.config import OptimizationConfig
        from gaussianhaircut_torch.models import gaussian_model as gm
        from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
        from gaussianhaircut_torch.scene.cameras import CameraBatch
        from gaussianhaircut_torch.train import stage1

        cfg = self.cfg
        n = self.init["xyz"].shape[0]
        params = gm.GaussianParams(**{k: v.clone() for k, v in self.init.items()})
        zero = torch.zeros(n, device=self.device)
        aux = gm.GaussianAux(alive=torch.ones(n, dtype=torch.bool, device=self.device),
                             max_radii2d=zero, xyz_grad_accum=zero.clone(), denom=zero.clone())
        model = gm.GaussianModelState(params, aux, cfg["active_sh_degree"], cfg["sh_degree"],
                                      cfg["spatial_lr_scale"])
        self.state = stage1.init_train_state(model, cfg["views"], cfg["use_barf"])
        self.cam_batch = CameraBatch(self.cams["colmap_transform"], self.cams["fovx"],
                                     self.cams["fovy"])
        self.gt_batch = stage1.GtBatch(**self.gt)
        self.kw = dict(active_sh_degree=cfg["active_sh_degree"], width=cfg["width"],
                       height=cfg["height"],
                       raster_cfg=RasterConfig(tile_w=cfg["tile"], tile_h=cfg["tile"],
                                               chunk=cfg["chunk"]),
                       opt_cfg=OptimizationConfig(**cfg["optimization"]),
                       trainable_cameras=cfg["trainable_cameras"],
                       trainable_intrinsics=cfg["trainable_intrinsics"],
                       use_barf=cfg["use_barf"], white_background=cfg["white_background"])
        self._train_step = stage1.train_step

    def _call(self, idx: int):
        self.state, m = self._train_step(self.state, self.cam_batch, self.gt_batch, idx,
                                         **self.kw)
        return m

    def start(self) -> None:
        """Build the port's state and run the checked steps through the
        window's own call, keeping what the comparison reads."""
        self._program()
        b1 = 0.9
        losses = []
        for k in range(CHECKED_STEPS):
            idx = self.order.next()
            self.checked_views.append(idx)
            losses.append(self._call(idx)["total"])
            if k == 0:
                s = self.state
                grad = {name: float(torch.linalg.norm(getattr(s.opt.mu, name))) / (1 - b1)
                        for name in PARAM_LEAVES}
                grad.update({f"cam.{name}": float(torch.linalg.norm(
                    getattr(s.cam_opt.mu, name)[idx])) / (1 - b1) for name in CAM_LEAVES})
        s = self.state
        change = {name: float(torch.linalg.norm(getattr(s.model.params, name) - self.init[name]))
                  for name in PARAM_LEAVES}
        change.update({f"cam.{name}": float(torch.linalg.norm(getattr(s.cam_res, name)))
                       for name in CAM_LEAVES})
        change.update({f"aux.{name}": float(torch.linalg.norm(getattr(s.model.aux, name)))
                       for name in AUX_LEAVES})
        self.program_readings = Readings([float(x) for x in losses], grad, change,
                                         self._groups(change))
        self.init = {k: v.cpu() for k, v in self.init.items()}

    @staticmethod
    def _groups(change: dict) -> dict:
        return {k: "aux" if k.startswith("aux.") else "param" for k in change}

    def step(self):
        """One window step -> (views, num_rendered, loss on the device)."""
        m = self._call(self.order.next())
        return 1, m["num_rendered"], m["total"]

    def snapshot(self) -> dict:
        """What the count of the next step's work needs (cloned on the card)."""
        s = self.state
        idx = self.order.peek()
        return {"params": {k: getattr(s.model.params, k).detach().clone() for k in PARAM_LEAVES},
                "cam": {k: getattr(s.cam_res, k)[idx].detach().clone() for k in CAM_LEAVES},
                "idx": idx, "alive": s.model.aux.alive.clone()}

    def free(self) -> None:
        for name in ("state", "cam_batch", "gt_batch", "kw", "_train_step"):
            self.__dict__.pop(name, None)

    # ------------------------------------------------------- the reference --
    def _ref_state(self) -> dict:
        dev, n, views = self.device, self.init["xyz"].shape[0], self.cfg["views"]
        params = {k: v.to(dev) for k, v in self.init.items()}
        zeros = lambda d: {k: torch.zeros_like(v) for k, v in d.items()}
        cam = {"rotation": torch.zeros((views, 3), device=dev),
               "translation": torch.zeros((views, 3), device=dev),
               "fov": torch.zeros((views, 2), device=dev)}
        z = torch.zeros(n, device=dev)
        return {"params": params, "mu": zeros(params), "nu": zeros(params),
                "aux": {"max_radii2d": z, "xyz_grad_accum": z.clone(), "denom": z.clone()},
                "alive": torch.ones(n, dtype=torch.bool, device=dev), "cam": cam,
                "cam_mu": zeros(cam), "cam_nu": zeros(cam), "cam_count": [0] * views,
                "count": 0, "step": 0, "spatial_lr_scale": self.cfg["spatial_lr_scale"]}

    def reference_readings(self) -> Readings:
        """The reference's three steps from the same start (at the precision
        the caller set with ``reference.precision.mode``)."""
        state = self._ref_state()
        init = state["params"]
        losses = []
        for k, idx in enumerate(self.checked_views):
            state, loss = ref.step(state, self.cams, self.gt, idx, self.cfg)
            losses.append(loss)
            if k == 0:
                grad = {name: float(torch.linalg.norm(state["mu"][name])) / 0.1
                        for name in PARAM_LEAVES}
                grad.update({f"cam.{name}": float(torch.linalg.norm(state["cam_mu"][name][idx]))
                             / 0.1 for name in CAM_LEAVES})
        change = {name: float(torch.linalg.norm(state["params"][name] - init[name]))
                  for name in PARAM_LEAVES}
        change.update({f"cam.{name}": float(torch.linalg.norm(state["cam"][name]))
                       for name in CAM_LEAVES})
        change.update({f"aux.{name}": float(torch.linalg.norm(state["aux"][name]))
                       for name in AUX_LEAVES})
        return Readings(losses, grad, change, self._groups(change))

    def step_work(self, snap: dict) -> dict:
        """Operations and bytes of one step at the snapshot's state."""
        p = {k: v.to(self.device) for k, v in snap["params"].items()}
        idx = snap["idx"]
        cam = ref.geo.camera(self.cams["colmap_transform"][idx], self.cams["fovx"][idx],
                             self.cams["fovy"][idx], self.cfg["width"], self.cfg["height"],
                             *(snap["cam"][k].to(self.device) for k in CAM_LEAVES))
        work = R.count_work(ref.fields(p, snap["alive"].to(self.device)),
                            self.cfg["active_sh_degree"], cam, self.cfg["tile"])
        n_params = sum(v.numel() for v in p.values())
        elementwise = (3 * counts.PRECOMPUTE_OPS * work["gaussians"]
                       + 3 * counts.PIXEL_OPS["stage1"] * work["pixels"]
                       + counts.ADAM_OPS * n_params
                       + counts.DENSIFY_STATS_OPS * work["gaussians"])
        fwd_ops, fwd_bytes = counts.raster_fwd(work)
        bwd_ops, bwd_bytes = counts.raster_bwd(work)
        work.update(raster_fwd=(fwd_ops, fwd_bytes), raster_bwd=(bwd_ops, bwd_bytes),
                    step_ops=fwd_ops + bwd_ops + elementwise)
        return work
