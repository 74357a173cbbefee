"""Driver of ``gaussianhaircut_torch.train.stage2.train_step``: the stage-2
step that ``train()`` calls on one camera per iteration, in the loop's
camera order, with the self-trained diffusion prior (``--use_diffusion``)
and the draws of ``draw_stage2`` (roots, sigma, noise) made by the
benchmark's copy of that generator and passed in.

Inputs, all from the seed: the frozen head (a Gaussian population labelled
head), the scalp pool, the networks' weights and texture, the ring of views
with their ground truth, the camera order and the draws.  The port's state
is its own ``HairTrainState`` (modules of the port holding those weights, a
fresh AdamW state, the EMA a copy of the denoiser) at the configuration's
``start_step``; the reference gets the same tensors.
"""
from __future__ import annotations

import copy

import torch

from benchlib import counts, inputs, weights
from benchlib.compare import Readings
from reference import geometry as geo
from reference import render as R
from reference import stage2 as ref
from reference import strands as S

CHECKED_STEPS = 3


class Driver:
    stage = "stage2"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.views_per_step = 1
        self.head = inputs.gaussians(inputs.generator(seed, "head", device), cfg["head"]["count"],
                                     cfg["head"])
        self.pool = inputs.scalp_pool(inputs.generator(seed, "scalp", device), cfg["pool_size"])
        self.weights = weights.make(S.param_specs(cfg), inputs.generator(seed, "weights", device))
        self.cams = inputs.cameras(cfg, device)
        self.gt = inputs.ground_truth(inputs.generator(seed, "ground_truth", device),
                                      cfg["views"], cfg["width"], cfg["height"])
        self.order = inputs.CameraOrder(cfg["views"], seed)
        self.draw_gen = inputs.generator(seed, "draws", device)
        self.checked: list[tuple] = []
        self._pending = None

    # ------------------------------------------------------------- draws --
    def _draw(self) -> dict:
        cfg = self.cfg
        roots = inputs.sample_roots(self.draw_gen, cfg["pool_size"], cfg["num_strands"])
        d = cfg["unet"]
        sigma, noise = inputs.diffusion_draws(self.draw_gen, cfg["diffusion_input"],
                                              cfg["geometry_descriptor_size"], d["density_mean"],
                                              d["density_std"], d["sigma_min"], d["sigma_max"])
        return {"roots": roots, "sigma": sigma, "noise": noise}

    def _next(self) -> tuple:
        """The next step's (camera, draws), drawn once."""
        if self._pending is None:
            self._pending = (self.order.next(), self._draw())
        out, self._pending = self._pending, None
        return out

    # ------------------------------------------------------------ the port --
    def _program(self):
        from gaussianhaircut_torch.config import OptimizationConfig
        from gaussianhaircut_torch.models import gaussian_model as gm
        from gaussianhaircut_torch.models.diffusion import Denoiser, DiffusionConfig
        from gaussianhaircut_torch.models.strand_prior import ColorDecoder, StrandDecoder
        from gaussianhaircut_torch.models.textured_strands import (
            ScalpPool, StrandParams, TexturedStrandsConfig)
        from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
        from gaussianhaircut_torch.scene.cameras import CameraBatch, CameraResiduals
        from gaussianhaircut_torch.train import optim, stage1, stage2

        cfg, dev = self.cfg, self.device
        u = cfg["unet"]
        with torch.device("meta"):
            params = StrandParams(
                torch.empty(self.weights["texture"].shape),
                StrandDecoder(length=cfg["strand_length"]),
                ColorDecoder(sh_degree=cfg["sh_degree"]),
                Denoiser(DiffusionConfig(
                    input_channels=u["input_channels"], input_size=u["input_size"],
                    mapping_out=u["mapping_out"], depths=tuple(u["depths"]),
                    channels=tuple(u["channels"]), sigma_data=u["sigma_data"],
                    sigma_min=u["sigma_min"], sigma_max=u["sigma_max"],
                    density_mean=u["density_mean"], density_std=u["density_std"])))
        params = params.to_empty(device=dev)
        params.load_state_dict(self.weights, strict=True)
        state = stage2.HairTrainState(
            params, optim.adam_init(dict(params.named_parameters())), self.traffic["start_step"],
            torch.Generator(device=dev), copy.deepcopy(params.denoiser).requires_grad_(False))
        n = self.head["xyz"].shape[0]
        head = gm.GaussianModelState(
            gm.GaussianParams(**{k: v.clone() for k, v in self.head.items()}),
            gm.GaussianAux(alive=torch.ones(n, dtype=torch.bool, device=dev),
                           max_radii2d=torch.zeros(n, device=dev),
                           xyz_grad_accum=torch.zeros(n, device=dev),
                           denom=torch.zeros(n, device=dev)),
            cfg["sh_degree"], cfg["sh_degree"], 1.0)
        self.state = state
        self.head_fields = stage2.make_head_fields(head)
        self.program_pool = ScalpPool(self.pool["origins"], self.pool["uvs"],
                                      self.pool["local2world"])
        self.cam_batch = CameraBatch(self.cams["colmap_transform"], self.cams["fovx"],
                                     self.cams["fovy"])
        self.gt_batch = stage1.GtBatch(**self.gt)
        self.residuals = CameraResiduals.create(cfg["views"], True, dev)
        self.radius = torch.tensor(cfg["strand_radius"], dtype=torch.float32, device=dev)
        scfg = TexturedStrandsConfig(
            num_strands=cfg["num_strands"], texture_size=cfg["texture_size"],
            geometry_descriptor_size=cfg["geometry_descriptor_size"],
            appearance_descriptor_size=cfg["appearance_descriptor_size"],
            strand_length=cfg["strand_length"], sh_degree=cfg["sh_degree"],
            scale_decoder=cfg["scale_decoder"], diffusion_input=cfg["diffusion_input"],
            use_diffusion=True, pool_size=cfg["pool_size"])
        self.kw = dict(scfg=scfg, width=cfg["width"], height=cfg["height"],
                       raster_cfg=RasterConfig(tile_w=cfg["tile"], tile_h=cfg["tile"],
                                               chunk=cfg["chunk"]),
                       opt_cfg=OptimizationConfig(**cfg["optimization"]),
                       white_background=cfg["white_background"], base_lr=cfg["base_lr"],
                       total_iters=cfg["total_iters"])
        self._draws_type = stage2.Stage2Draws
        self._train_step = stage2.train_step

    def _call(self, idx: int, draws: dict):
        g = self.gt_batch
        self.state, m = self._train_step(
            self.state, self.head_fields, self.program_pool, self.cam_batch, g.image[idx],
            g.mask[idx], g.orient_angle[idx], g.orient_conf[idx], idx, self.residuals,
            self.radius, None, None, draws=self._draws_type(**draws), **self.kw)
        return m

    def start(self) -> None:
        self._program()
        self.init_ema = {k: v.detach().clone() for k, v in self.state.ema.named_parameters()}
        losses = []
        for k in range(CHECKED_STEPS):
            idx, draws = self._next()
            self.checked.append((idx, draws))
            losses.append(self._call(idx, draws)["total"])
            if k == 0:
                grad = {name: float(torch.linalg.norm(m)) / 0.1
                        for name, m in self.state.opt.mu.items()}
        params = {k: v.detach() for k, v in self.state.params.named_parameters()}
        change = {k: float(torch.linalg.norm(params[k] - self.weights[k])) for k in params}
        change.update({f"ema.denoiser.{k}": float(torch.linalg.norm(e - self.init_ema[k]))
                       for k, e in self.state.ema.named_parameters()})
        self.program_readings = Readings([float(x) for x in losses], grad, change,
                                         self._groups(change))
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        del self.init_ema

    @staticmethod
    def _groups(change: dict) -> dict:
        return {k: "ema" if k.startswith("ema.") else "param" for k in change}

    def step(self):
        idx, draws = self._next()
        m = self._call(idx, draws)
        return 1, m["num_rendered"], m["total"]

    def snapshot(self) -> dict:
        """What the count of the next step's work needs (cloned on the card)."""
        self._pending = self._next()
        idx, draws = self._pending
        p = {k: v.detach().clone() for k, v in self.state.params.named_parameters()
             if not k.startswith("denoiser.")}
        return {"params": p, "idx": idx, "roots": draws["roots"].clone()}

    def free(self) -> None:
        for name in ("state", "head_fields", "program_pool", "cam_batch", "gt_batch",
                     "residuals", "radius", "kw", "_train_step", "_draws_type"):
            self.__dict__.pop(name, None)

    # ------------------------------------------------------- the reference --
    def _head_fields(self) -> R.Fields:
        h = self.head
        n = h["xyz"].shape[0]
        zeros = torch.zeros((n, 1), device=self.device)
        return R.Fields(
            xyz=h["xyz"], features=torch.cat([h["features_dc"], h["features_rest"]], 1),
            scaling=torch.exp(h["scaling"]), rotation=geo.build_rotation(h["rotation"]),
            opacity=torch.sigmoid(h["opacity"]), label=zeros, orient_conf=zeros.clone(),
            valid=torch.sigmoid(h["label"])[:, 0] < 0.5, viewspace=torch.zeros_like(h["xyz"]),
            use_direction=torch.zeros(n, device=self.device))

    def reference_readings(self) -> Readings:
        dev = self.device
        w = {k: v.to(dev) for k, v in self.weights.items()}
        zeros = {k: torch.zeros_like(v) for k, v in w.items()}
        state = {"params": w, "mu": zeros, "nu": {k: v.clone() for k, v in zeros.items()},
                 "ema": {k: v.clone() for k, v in w.items() if k.startswith(ref.DENOISER)},
                 "count": 0, "step": self.traffic["start_step"]}
        head = self._head_fields()
        losses = []
        for k, (idx, draws) in enumerate(self.checked):
            state, loss = ref.step(state, head, self.pool, self.cams, self.gt, idx, draws,
                                   self.cfg)
            losses.append(loss)
            if k == 0:
                grad = {name: float(torch.linalg.norm(m)) / 0.1 for name, m in state["mu"].items()}
        change = {k: float(torch.linalg.norm(state["params"][k] - w[k])) for k in w}
        change.update({f"ema.{k}": float(torch.linalg.norm(e - w[k]))
                       for k, e in state["ema"].items()})
        return Readings(losses, grad, change, self._groups(change))

    def step_work(self, snap: dict) -> dict:
        cfg, dev = self.cfg, self.device
        w = {k: v.to(dev) for k, v in snap["params"].items()}
        with torch.no_grad():
            hair = S.hair_fields(w, self.pool, snap["roots"].to(dev), cfg, cfg["strand_radius"])
            fields = R.Fields.cat(self._head_fields(), hair)
            cam = ref.view_camera(self.cams, snap["idx"], cfg)
            work = R.count_work(fields, cfg["sh_degree"], cam, cfg["tile"])
        n, length = cfg["num_strands"], cfg["strand_length"]
        nets = (counts.strand_decoder(n, length) + counts.colour_decoder(n, cfg["sh_degree"]))
        unet = counts.unet(cfg["unet"])
        # forward + backward (twice) of the decoders and the trained UNet; the
        # EMA UNet's forward and its input gradient (once)
        net_ops = 3 * nets + 3 * unet + 2 * unet
        n_params = sum(v.numel() for v in self.weights.values())
        n_unet = sum(v.numel() for k, v in self.weights.items() if k.startswith(ref.DENOISER))
        elementwise = (3 * counts.PRECOMPUTE_OPS * work["gaussians"]
                       + 3 * counts.SEGMENT_OPS * n * (length - 1)
                       + 3 * counts.PIXEL_OPS["stage2"] * work["pixels"]
                       + (counts.ADAMW_OPS + counts.CLIP_OPS) * n_params
                       + counts.EMA_OPS * n_unet)
        fwd_ops, fwd_bytes = counts.raster_fwd(work)
        bwd_ops, bwd_bytes = counts.raster_bwd(work)
        work.update(raster_fwd=(fwd_ops, fwd_bytes), raster_bwd=(bwd_ops, bwd_bytes),
                    step_ops=fwd_ops + bwd_ops + net_ops + elementwise)
        return work
