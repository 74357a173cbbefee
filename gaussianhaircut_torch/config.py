"""Configuration dataclasses (a copy of ``gaussianhaircut_tpu/config.py``).

Same field names and defaults as the JAX package, so a run configured for one
translates 1:1 to the other.  The JAX package's ``raster_backend`` has no
counterpart: the port's compositing route follows the tensors' device (the
CUDA kernels for CUDA tensors, the plain PyTorch version for CPU tensors).
"""
from __future__ import annotations

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
