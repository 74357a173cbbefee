"""Stage-1 training CLI (port of ``gaussianhaircut_tpu/cli/
train_gaussians.py``; reference src/train_gaussians.py:295-321 -- same
flags).

    python3 -m gaussianhaircut_torch.cli.train_gaussians -s SCENE -m MODEL [...]

Runs on the GPU; ``--device cpu`` runs the plain PyTorch path on the CPU.
``--gui`` listens for the SIBR live viewer on ``--ip`` / ``--port``
(``render/network_gui.py``; the trainer answers its camera requests between
steps).  ``--mesh DATAxTILE`` trains on a (camera, tile-row) process mesh,
one process per rank:

    python -m torch.distributed.run --nproc_per_node=N \
        -m gaussianhaircut_torch.cli.train_gaussians --mesh DxT -s ... -m ...

with N = D * T; each rank takes ``cuda:LOCAL_RANK`` (``--device cuda:0``:
the ranks share one card, over gloo; ``--device cpu``: the CPU), rank 0
alone writes the model directory and serves the viewer (``parallel/mesh.py``).
The JAX-only ``--raster_backend`` and ``--instance_capacity_mult`` are not
accepted (see ``config.py``).
"""
from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from gaussianhaircut_torch import config as cfg_mod
from gaussianhaircut_torch.device import resolve_device
from gaussianhaircut_torch.parallel import mesh as mesh_mod
from gaussianhaircut_torch.render import network_gui
from gaussianhaircut_torch.scene.dataset import load_scene
from gaussianhaircut_torch.train import stage1


def main(argv=None):
    """Parse ``argv`` (default: ``sys.argv[1:]``), train, and return the
    final ``stage1.TrainState``."""
    parser = argparse.ArgumentParser("train_gaussians")
    cfg_mod.add_model_args(parser)
    cfg_mod.add_optim_args(parser)
    cfg_mod.add_pipeline_args(parser)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[1_000, 5_000, 15_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[1_000, 5_000, 15_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[1_000, 5_000, 15_000, 30_000])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--gui", action="store_true",
                        help="serve the SIBR live viewer on --ip / --port")
    parser.add_argument("--mesh", type=str, default="",
                        help="multi-device mesh 'DATAxTILE' (e.g. 4x2): cameras "
                        "shard over DATA ranks, each camera's tile rows over TILE "
                        "ranks; one process per rank under torch.distributed.run "
                        "(empty = one device)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda (cuda:LOCAL_RANK under "
                        "--mesh; cpu runs the plain PyTorch path)")
    args = parser.parse_args(argv)

    if args.mesh:
        mesh_mod.require_launcher(*mesh_mod.parse_mesh_spec(args.mesh))
    launched = bool(args.mesh) and "WORLD_SIZE" in os.environ
    device = (mesh_mod.init_distributed(args.device) if launched
              else resolve_device(args.device))
    main_rank = mesh_mod.process_rank() == 0
    if args.gui and main_rank:
        network_gui.init(args.ip, args.port)
    model_cfg = cfg_mod.extract(cfg_mod.ModelConfig, args)
    opt_cfg = cfg_mod.extract(cfg_mod.OptimizationConfig, args)
    pipe_cfg = cfg_mod.extract(cfg_mod.PipelineConfig, args)
    save_iters = sorted(set(args.save_iterations + [opt_cfg.iterations]))

    if main_rank:
        print(f"Optimizing {model_cfg.model_path}")
        cfg_mod.save_config(model_cfg.model_path, model_cfg, opt_cfg, pipe_cfg)

    scene = load_scene(model_cfg)
    state = stage1.train(model_cfg, opt_cfg, pipe_cfg, scene,
                         test_iterations=tuple(args.test_iterations),
                         save_iterations=tuple(save_iters),
                         checkpoint_iterations=tuple(args.checkpoint_iterations),
                         start_checkpoint=args.start_checkpoint,
                         mesh_spec=args.mesh, device=device)
    if main_rank:
        print("\nTraining complete.")
    if launched:
        dist.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
