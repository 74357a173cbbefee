"""Configuration dataclasses and their argparse bridge (a copy of
``gaussianhaircut_tpu/config.py``).

Same field names, defaults and CLI flags as the JAX package, so a run
configured for one translates 1:1 to the other, and ``cfg_args.json`` is
written the same way.  Two JAX pipeline knobs have no counterpart and their
flags are not accepted:

- ``--raster_backend``: the port's compositing route follows the tensors'
  device (the CUDA kernels for CUDA tensors, the plain PyTorch version for
  CPU tensors);
- ``--instance_capacity_mult``: the port's binning sizes its instance buffer
  from ``num_rendered`` on every call, so there is no static capacity.

``load_config`` ignores those two keys in a ``cfg_args.json`` the JAX
package wrote.
"""
from __future__ import annotations

import dataclasses
import json
import os
from argparse import ArgumentParser
from dataclasses import dataclass


@dataclass
class ModelConfig:
    """Reference: ModelParams (arguments/__init__.py:47-76)."""
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images_2"
    resolution: int = -1
    iteration_data: int = 30_000
    white_background: bool = False
    data_device: str = "cuda"
    binarize_masks: bool = False
    eval: bool = False
    load_synthetic_rgba: bool = False
    load_synthetic_geom: bool = False
    trainable_cameras: bool = True
    trainable_intrinsics: bool = True
    use_barf: bool = True
    flame_mesh_dir: str = ""
    strand_scale: float = 1e-3
    interpolate_cameras: bool = False
    speed_up: int = 4
    max_frames: int = 300
    frame_offset: int = 0


@dataclass(frozen=True)
class OptimizationConfig:
    """Reference: OptimizationParams (arguments/__init__.py:85-122)."""
    iterations: int = 30_000
    iterations_cam: int = 15_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    cam_lr_max_steps: int = 15_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    label_lr: float = 0.05
    orient_conf_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    cam_rotation_lr: float = 0.001
    cam_translation_lr_init: float = 0.0016
    cam_translation_lr_final: float = 0.000016
    cam_fov_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dl1: float = 0.8
    lambda_dssim: float = 0.2
    lambda_dmask: float = 0.2
    lambda_dorient: float = 0.0
    lambda_dsds: float = 0.0
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    opacity_reg_from_iter: int = 30_000
    gaussian_pruning_threshold: float = 0.5
    train_orient_conf: bool = True
    use_gt_orient_conf: bool = True
    # stage 2/3 fields, kept so configurations translate 1:1
    hair_grad_clip: float = 1.0
    sds_grad_ratio: float = 1.0
    diffusion_ema_warmup: int = 2000
    diffusion_ema_decay: float = 0.995


@dataclass
class PipelineConfig:
    """Reference: PipelineParams (arguments/__init__.py:78-83) + port knobs."""
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    gaussian_capacity: int = 0              # 0 -> auto from init size
    tile: int = 32
    data_parallel: int = 1                  # a JAX flag no stage-1 code reads


def add_dataclass_args(parser: ArgumentParser, dc_type, shorthand: dict | None = None):
    """Register dataclass fields as --flags (bools become store_true, as in
    arguments/__init__.py:29-38)."""
    shorthand = shorthand or {}
    for f in dataclasses.fields(dc_type):
        names = [f"--{f.name}"]
        if f.name in shorthand:
            names.append(shorthand[f.name])
        if f.type in ("bool", bool):
            parser.add_argument(*names, default=f.default, action="store_true")
        else:
            parser.add_argument(*names, default=f.default, type=type(f.default))
    return parser


_SHORTHANDS = {"source_path": "-s", "model_path": "-m", "images": "-i",
               "resolution": "-r", "white_background": "-w"}


def add_model_args(parser):
    return add_dataclass_args(parser, ModelConfig, _SHORTHANDS)


def add_optim_args(parser):
    return add_dataclass_args(parser, OptimizationConfig)


def add_pipeline_args(parser):
    return add_dataclass_args(parser, PipelineConfig)


def extract(dc_type, args):
    """Build a dataclass from a parsed argparse Namespace."""
    kwargs = {f.name: getattr(args, f.name) for f in dataclasses.fields(dc_type)
              if hasattr(args, f.name)}
    cfg = dc_type(**kwargs)
    if isinstance(cfg, ModelConfig) and cfg.source_path:
        cfg.source_path = os.path.abspath(cfg.source_path)
    return cfg


def save_config(model_path: str, model: ModelConfig, optim=None, pipe=None) -> None:
    """Persist the configs as ``cfg_args.json`` (the reference's cfg_args,
    train_gaussians.py:221-222), reloadable without eval()."""
    os.makedirs(model_path, exist_ok=True)
    blob = {"model": dataclasses.asdict(model)}
    if optim is not None:
        blob["optim"] = dataclasses.asdict(optim)
    if pipe is not None:
        blob["pipeline"] = dataclasses.asdict(pipe)
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(blob, f, indent=2)


def _known(dc_type, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(dc_type)}
    return {k: v for k, v in d.items() if k in names}


def load_config(model_path: str):
    with open(os.path.join(model_path, "cfg_args.json")) as f:
        blob = json.load(f)
    model = ModelConfig(**_known(ModelConfig, blob["model"]))
    optim = OptimizationConfig(**_known(OptimizationConfig, blob.get("optim", {})))
    pipe = PipelineConfig(**_known(PipelineConfig, blob.get("pipeline", {})))
    return model, optim, pipe
