"""Merge per-frame PIXIE / SMPL-X parameter pickles into the one
``initialization_pixie`` stream the FLAME-fitting stage reads (port of
``gaussianhaircut_tpu/cli/merge_smplx_predictions.py``; reference
src/preprocessing/merge_smplx_predictions.py).

The output is a CONCATENATED pickle stream: one ``pickle.dump`` per frame,
in sorted path order; readers call ``pickle.load`` repeatedly on one open
file (``read_stream``).  Input: <data_path>/pixie/<frame>/<name>_param.pkl,
pickles written by the PIXIE stage of the same pipeline.

    python3 -m gaussianhaircut_torch.cli.merge_smplx_predictions --data_path SCENE
"""
from __future__ import annotations

import argparse
import os
import pickle
from glob import glob


def merge(data_path: str, out_name: str = "initialization_pixie") -> int:
    """Write the stream; returns the number of frames merged."""
    param_paths = sorted(glob(os.path.join(data_path, "pixie", "*", "*_param.pkl")))
    with open(os.path.join(data_path, out_name), "wb") as out:
        for p in param_paths:
            with open(p, "rb") as f:
                pickle.dump(pickle.load(f), out)
    return len(param_paths)


def read_stream(path: str):
    """The frames of a concatenated pickle stream, in order."""
    with open(path, "rb") as f:
        while True:
            try:
                yield pickle.load(f)
            except EOFError:
                return


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("merge_smplx_predictions")
    ap.add_argument("--data_path", required=True)
    args = ap.parse_args(argv)
    n = merge(args.data_path)
    print(f"merged {n} pixie param pickles -> "
          f"{os.path.join(args.data_path, 'initialization_pixie')}")
    return n


if __name__ == "__main__":
    main()
