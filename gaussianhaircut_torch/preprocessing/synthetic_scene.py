"""Reorganize a synthetic (NeuralHaircut-style) dump into the pipeline's
directory layout (port of ``gaussianhaircut_tpu/preprocessing/
synthetic_scene.py``; reference src/preprocessing/
preprocess_synthetic_scene.py): images, masks, orientation maps and the
camera files are copied where the trainers read them.  Host file work only.

    python3 -m gaussianhaircut_torch.preprocessing.synthetic_scene --src DUMP --dst SCENE
"""
from __future__ import annotations

import argparse
import os
import shutil

# dump directory -> the pipeline's directory
_LAYOUT = {
    "image": "images_2",
    "images": "images_2",
    "hair_mask": "masks_2/hair",
    "mask": "masks_2/body",
    "orientation_maps": "orientations_2/angles",
    "confidence_maps": "orientations_2/vars",
}
_FILES = ("cameras.npz", "projection.npy", "point_cloud.ply")


def preprocess_synthetic_scene(src_dir: str, dst_dir: str) -> None:
    """Copy the dump's directories (an existing target is kept) and its
    camera and point files."""
    os.makedirs(dst_dir, exist_ok=True)
    for src_name, dst_name in _LAYOUT.items():
        s = os.path.join(src_dir, src_name)
        if not os.path.isdir(s):
            continue
        d = os.path.join(dst_dir, dst_name)
        os.makedirs(os.path.dirname(d), exist_ok=True)
        if not os.path.exists(d):
            shutil.copytree(s, d)
    for f in _FILES:
        s = os.path.join(src_dir, f)
        if os.path.exists(s):
            shutil.copy2(s, os.path.join(dst_dir, f))


def main(argv=None) -> None:
    p = argparse.ArgumentParser("preprocess_synthetic_scene")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    a = p.parse_args(argv)
    preprocess_synthetic_scene(a.src, a.dst)


if __name__ == "__main__":
    main()
