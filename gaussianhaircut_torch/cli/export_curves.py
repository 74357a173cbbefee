"""Export stage-3 strand polylines as a pickle and a PLY (port of
``gaussianhaircut_tpu/cli/export_curves.py``; the contract of reference
src/preprocessing/export_curves.py).

    python3 -m gaussianhaircut_torch.cli.export_curves --data_dir DATA \\
        --model_name NAME [--iter 10000]

Reads ``DATA/curves_reconstruction/NAME/checkpoints/<iter>.npz`` (a stage-3
checkpoint of either package) and writes ``<iter>_strands.pkl`` (a float32
[N, L, 3] numpy array) and ``<iter>_strands.ply`` (points only) under
``.../NAME/strands/``.  Runs on the GPU; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from gaussianhaircut_torch.scene import ply as ply_io


def export_strand_points(pts: np.ndarray, out_dir: str, iteration) -> None:
    """pts [N, L, 3] -> out_dir/{iteration}_strands.pkl and .ply."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{iteration}_strands.pkl"), "wb") as f:
        pickle.dump(pts, f)
    xyz = pts.reshape(-1, 3)
    v = np.zeros(xyz.shape[0], dtype=[(n, "<f4") for n in ("x", "y", "z", "nx", "ny", "nz")])
    for i, n in enumerate(("x", "y", "z")):
        v[n] = xyz[:, i]
    ply_io.write_ply(os.path.join(out_dir, f"{iteration}_strands.ply"), v)


def main(argv=None) -> np.ndarray:
    """Parse ``argv`` (default ``sys.argv[1:]``), export, and return the
    exported points."""
    from gaussianhaircut_torch.train import stage3

    parser = argparse.ArgumentParser("export_curves")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--model_name", required=True)
    parser.add_argument("--iter", default="10000")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default cuda")
    args = parser.parse_args(argv)

    root = os.path.join(args.data_dir, "curves_reconstruction", args.model_name)
    state = stage3.load_checkpoint(os.path.join(root, "checkpoints", f"{args.iter}.npz"),
                                   args.device)
    pts = stage3.export_points(state)
    print(f"Saving {pts.shape[0]} strands")
    export_strand_points(pts, os.path.join(root, "strands"), args.iter)
    return pts


if __name__ == "__main__":
    main()
