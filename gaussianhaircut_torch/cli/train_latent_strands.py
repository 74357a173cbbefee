"""Stage-2 training CLI (port of ``gaussianhaircut_tpu/cli/
train_latent_strands.py``; reference src/train_latent_strands.py:272-309,
the same flags).

    python3 -m gaussianhaircut_torch.cli.train_latent_strands -s SCENE -m MODEL \\
        --model_path_hair HAIR [--use_diffusion] [...]

Reads the stage-1 model (its newest ``point_cloud/iteration_*`` PLY and
camera pickles), trains the textured strands and writes ``metrics.jsonl``
and ``checkpoints/<iter>.npz`` under ``--model_path_hair``.  Without a
``--flame_mesh_dir`` the scalp is the synthetic polar cap.  Runs on the GPU;
``--device cpu`` runs the plain PyTorch path on the CPU.
"""
from __future__ import annotations

import argparse
import os
import pickle

from gaussianhaircut_torch import config as cfg_mod


def load_scene_scale(source_path: str) -> float:
    """``scale.pickle``'s scale, or 1."""
    p = os.path.join(source_path, "scale.pickle")
    if os.path.exists(p):
        with open(p, "rb") as f:
            return float(pickle.load(f)["scale"])
    return 1.0


def add_strand_args(parser: argparse.ArgumentParser) -> None:
    """The strand network's size flags, shared with ``train_strands``."""
    parser.add_argument("--num_strands", type=int, default=10_000)
    parser.add_argument("--texture_size", type=int, default=256)
    parser.add_argument("--strand_length", type=int, default=100)
    parser.add_argument("--diffusion_input", type=int, default=32)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (cpu runs the plain "
                        "PyTorch path)")


def load_head_and_pool(model_cfg, scfg, args, device):
    """The scene, the frozen stage-1 head, the camera residuals and the
    scalp pool, as both strand stages read them."""
    from gaussianhaircut_torch.cli.render_gaussians import (
        find_head_ply, find_max_iteration, load_camera_residuals)
    from gaussianhaircut_torch.models import gaussian_model as gm
    from gaussianhaircut_torch.models.textured_strands import (
        ScalpPool, synthetic_scalp_pool)
    from gaussianhaircut_torch.scene.dataset import load_scene

    scene = load_scene(model_cfg)
    iteration = find_max_iteration(model_cfg.model_path)
    head_ply = find_head_ply(model_cfg.model_path, iteration, args.pointcloud_path_head)
    head_model = gm.load_ply(head_ply, 0, model_cfg.sh_degree, device=device)
    residuals = (load_camera_residuals(model_cfg.model_path, iteration,
                                       scene.train_cameras, device)
                 if model_cfg.trainable_cameras else None)
    if model_cfg.flame_mesh_dir and os.path.isdir(model_cfg.flame_mesh_dir):
        pool = ScalpPool.from_flame_dir(model_cfg.flame_mesh_dir,
                                        model_cfg.source_path, scfg)
    else:
        print("[warn] no flame_mesh_dir; using synthetic scalp pool")
        pool = synthetic_scalp_pool(scfg.pool_size)
    return scene, head_model, residuals, pool


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), train, and return the
    final ``stage2.HairTrainState``."""
    from gaussianhaircut_torch.device import resolve_device
    from gaussianhaircut_torch.models.textured_strands import TexturedStrandsConfig
    from gaussianhaircut_torch.train import stage2

    parser = argparse.ArgumentParser("train_latent_strands")
    cfg_mod.add_model_args(parser)
    cfg_mod.add_optim_args(parser)
    cfg_mod.add_pipeline_args(parser)
    parser.add_argument("--model_path_hair", type=str, required=True)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[-1],
                        help="accepted for a stage-1-compatible invocation; "
                        "stage 2 has no test evaluation")
    parser.add_argument("--pointcloud_path_head", type=str, default="")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[20_000])
    parser.add_argument("--start_checkpoint_hair", type=str, default=None)
    add_strand_args(parser)
    parser.add_argument("--use_diffusion", action="store_true",
                        help="apply the L_diff latent-texture prior at lambda_dsds "
                        "(train_latent_strands.py:140-152)")
    parser.add_argument("--prior_checkpoint", type=str, default="",
                        help="a prior npz (the JAX package's layout); its denoiser "
                        "is used frozen and its decoder warm-starts the strand "
                        "decoder. Implies --use_diffusion.")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model_cfg = cfg_mod.extract(cfg_mod.ModelConfig, args)
    opt_cfg = cfg_mod.extract(cfg_mod.OptimizationConfig, args)
    pipe_cfg = cfg_mod.extract(cfg_mod.PipelineConfig, args)
    scfg = TexturedStrandsConfig(num_strands=args.num_strands,
                                 texture_size=args.texture_size,
                                 strand_length=args.strand_length,
                                 diffusion_input=args.diffusion_input,
                                 sh_degree=model_cfg.sh_degree,
                                 use_diffusion=args.use_diffusion or bool(args.prior_checkpoint))

    denoiser = prior = None
    if args.prior_checkpoint:
        from gaussianhaircut_torch.models.prior_io import load_prior
        prior = load_prior(args.prior_checkpoint, scfg.strand_length,
                           scfg.diffusion_input, device)
        denoiser = prior.get("denoiser")
        if denoiser is None:
            print("[warn] prior checkpoint has no denoiser section; "
                  "training a self-prior denoiser jointly")
        else:
            denoiser.requires_grad_(False)
            if opt_cfg.hair_grad_clip > 0:
                print(f"[note] hair_grad_clip={opt_cfg.hair_grad_clip} deviates from "
                      "the reference's unclipped training; with a converted "
                      "pretrained prior pass --hair_grad_clip 0 for its semantics")

    scene, head_model, residuals, pool = load_head_and_pool(model_cfg, scfg, args, device)
    state = stage2.train(model_cfg, opt_cfg, scfg, pipe_cfg, scene, head_model, pool,
                         load_scene_scale(model_cfg.source_path), residuals,
                         model_path_hair=args.model_path_hair,
                         checkpoint_iterations=tuple(args.checkpoint_iterations),
                         start_checkpoint=args.start_checkpoint_hair,
                         denoiser=denoiser, prior=prior, device=device)
    print("\nTraining complete.")
    return state


if __name__ == "__main__":
    main()
