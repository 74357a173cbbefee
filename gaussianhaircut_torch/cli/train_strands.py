"""Stage-3 training CLI (port of ``gaussianhaircut_tpu/cli/train_strands.py``;
reference src/train_strands.py:269-306, the same flags).

    python3 -m gaussianhaircut_torch.cli.train_strands -s SCENE -m MODEL \\
        --model_path_hair HAIR --model_path_curves CURVES \\
        --start_checkpoint_hair HAIR/checkpoints/<iter>.npz [--use_sds] [...]

Starts from a stage-2 checkpoint of either package and writes
``metrics.jsonl`` and ``checkpoints/<iter>.npz`` under
``--model_path_curves``.  With ``--use_sds`` and no ``--prior_checkpoint``
the SDS prior is a fresh one (``prior_io.init_prior``).  Runs on the GPU;
``--device cpu`` runs the plain PyTorch path on the CPU.
"""
from __future__ import annotations

import argparse

from gaussianhaircut_torch import config as cfg_mod
from gaussianhaircut_torch.cli.train_latent_strands import (
    add_strand_args, load_head_and_pool, load_scene_scale,
)


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), train, and return the
    final ``stage3.CurvesTrainState``."""
    import torch

    from gaussianhaircut_torch.device import resolve_device
    from gaussianhaircut_torch.models import prior_io
    from gaussianhaircut_torch.models.textured_strands import TexturedStrandsConfig
    from gaussianhaircut_torch.train import stage2, stage3

    parser = argparse.ArgumentParser("train_strands")
    cfg_mod.add_model_args(parser)
    cfg_mod.add_optim_args(parser)
    cfg_mod.add_pipeline_args(parser)
    parser.add_argument("--model_path_hair", type=str, required=True)
    parser.add_argument("--model_path_curves", type=str, required=True)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[-1],
                        help="accepted for a stage-1-compatible invocation; "
                        "stage 3 has no test evaluation")
    parser.add_argument("--pointcloud_path_head", type=str, default="")
    parser.add_argument("--start_checkpoint_hair", type=str, required=True,
                        help="stage-2 checkpoint npz")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[10_000])
    parser.add_argument("--start_checkpoint_curves", type=str, default=None)
    add_strand_args(parser)
    parser.add_argument("--use_sds", action="store_true",
                        help="apply the HAAR-style SDS regularizer at lambda_dsds "
                        "(gaussian_model_strands.py:456-515)")
    parser.add_argument("--prior_checkpoint", type=str, default="",
                        help="a strand-prior npz (the JAX package's layout). "
                        "Implies --use_sds.")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model_cfg = cfg_mod.extract(cfg_mod.ModelConfig, args)
    opt_cfg = cfg_mod.extract(cfg_mod.OptimizationConfig, args)
    pipe_cfg = cfg_mod.extract(cfg_mod.PipelineConfig, args)
    scfg = TexturedStrandsConfig(num_strands=args.num_strands,
                                 texture_size=args.texture_size,
                                 strand_length=args.strand_length,
                                 diffusion_input=args.diffusion_input,
                                 sh_degree=model_cfg.sh_degree)

    scene, head_model, residuals, pool = load_head_and_pool(model_cfg, scfg, args, device)
    # scfg has no diffusion, so a stage-2 denoiser in the checkpoint is not read
    hair_state = stage2.init_hair_state(scfg, 0, device=device)
    hair_state = stage2.load_checkpoint(args.start_checkpoint_hair, hair_state)

    use_sds = args.use_sds or bool(args.prior_checkpoint)
    prior = None
    if use_sds:
        if args.prior_checkpoint:
            prior = prior_io.load_strand_prior(args.prior_checkpoint, scfg.strand_length,
                                               scfg.diffusion_input, device)
            if opt_cfg.hair_grad_clip > 0 or opt_cfg.sds_grad_ratio > 0:
                print("[note] hair_grad_clip/sds_grad_ratio deviate from the "
                      "reference's unclipped joint-SDS training; with a converted "
                      "pretrained prior pass --hair_grad_clip 0 --sds_grad_ratio 0 "
                      "for its semantics")
        else:
            print("[warn] --use_sds without --prior_checkpoint: using a fresh "
                  "(untrained) prior")
            prior = prior_io.init_prior(scfg, torch.Generator().manual_seed(7), device)
        if "denoiser" not in prior:
            # the stage-2 self-prior denoiser, else a fresh one
            if hair_state.params.denoiser is not None:
                prior["denoiser"] = hair_state.params.denoiser
            else:
                prior["denoiser"] = prior_io.init_prior(
                    scfg, torch.Generator().manual_seed(8), device)["denoiser"]

    state = stage3.train(
        model_cfg, opt_cfg, scfg, pipe_cfg, scene, head_model, hair_state.params, pool,
        load_scene_scale(model_cfg.source_path), args.num_strands, residuals,
        model_path_curves=args.model_path_curves,
        checkpoint_iterations=tuple(args.checkpoint_iterations),
        start_checkpoint=args.start_checkpoint_curves, prior=prior, use_sds=use_sds,
        device=device)
    print("\nTraining complete.")
    return state


if __name__ == "__main__":
    main()
