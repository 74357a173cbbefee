"""Export stage-2 latent strands at high density (port of
``gaussianhaircut_tpu/cli/export_strands.py``; the contract of reference
src/preprocessing/export_strands.py): the trained generator at 30,000
strands, strands with half or more of their points inside the FLAME head
pruned, then the pkl and ply of ``export_curves``.

    python3 -m gaussianhaircut_torch.cli.export_strands --data_dir DATA \\
        --model_name NAME [--flame_mesh_dir FLAME] [--iter 20000]

The roots are a draw without replacement from the scalp pool: JAX's comes
from ``PRNGKey(7)``, the port's from a torch generator seeded 7, so the two
packages export different strands of the same texture; ``export`` takes the
root indices as an argument to make them the same.  The head test is the
winding number in float64 on the device.  Runs on the GPU; ``--device cpu``
runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def export(data_dir: str, model_name: str, flame_mesh_dir: str = "", iteration="20000",
           num_strands: int = 30_000, texture_size: int = 256, roots=None,
           device=None) -> dict:
    """Generate, prune and write; returns the kept points [K, L, 3], the
    keep mask over the generated strands and the seconds of the head test
    (``sdf_s``, ``sdf_terms``)."""
    from gaussianhaircut_torch.cli.export_curves import export_strand_points
    from gaussianhaircut_torch.device import resolve_device
    from gaussianhaircut_torch.models.textured_strands import (
        ScalpPool, TexturedStrandsConfig, generate_strands, sample_roots,
        synthetic_scalp_pool)
    from gaussianhaircut_torch.preprocessing.scene_tools import mesh_sdf_sign
    from gaussianhaircut_torch.train import stage2
    from gaussianhaircut_torch.utils import mesh as mesh_util

    device = resolve_device(device)
    scfg = TexturedStrandsConfig(num_strands=num_strands, texture_size=texture_size)
    if flame_mesh_dir and os.path.isdir(flame_mesh_dir):
        pool = ScalpPool.from_flame_dir(flame_mesh_dir, data_dir, scfg)
    else:
        pool = synthetic_scalp_pool(scfg.pool_size)
    pool = pool.to(device)

    ckpt = os.path.join(data_dir, "strands_reconstruction", model_name, "checkpoints",
                        f"{iteration}.npz")
    state = stage2.load_checkpoint(ckpt, stage2.init_hair_state(scfg, device=device))
    if roots is None:
        roots = sample_roots(pool, num_strands, torch.Generator(device=device).manual_seed(7))
    with torch.no_grad():
        pts = generate_strands(state.params, pool, scfg,
                               torch.as_tensor(roots, device=device)).points
    keep = np.ones(pts.shape[0], bool)
    out = {"sdf_s": 0.0, "sdf_terms": 0}
    flame_mesh = os.path.join(flame_mesh_dir, "stage_3", "mesh_final.obj")
    if os.path.exists(flame_mesh):
        head = mesh_util.load_obj(flame_mesh)
        t0 = time.perf_counter()
        inside = mesh_sdf_sign(pts.reshape(-1, 3), head, device)
        out.update(sdf_s=time.perf_counter() - t0,
                   sdf_terms=pts.shape[0] * pts.shape[1] * len(head.faces))
        keep = inside.reshape(pts.shape[0], -1).mean(axis=1) < 0.5
        print(f"Pruning {int((~keep).sum())} strands that intersect the head mesh")
    pts = pts.cpu().numpy()[keep]
    print(f"Saving {pts.shape[0]} strands")
    export_strand_points(pts, os.path.join(data_dir, "strands_reconstruction", model_name,
                                           "strands"), iteration)
    return dict(out, points=pts, keep=keep)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("export_strands")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--model_name", required=True)
    parser.add_argument("--flame_mesh_dir", default="")
    parser.add_argument("--iter", default="20000")
    parser.add_argument("--num_strands", type=int, default=30_000)
    parser.add_argument("--texture_size", type=int, default=256)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda")
    args = parser.parse_args(argv)
    return export(args.data_dir, args.model_name, args.flame_mesh_dir, args.iter,
                  args.num_strands, args.texture_size, device=args.device)


if __name__ == "__main__":
    main()
