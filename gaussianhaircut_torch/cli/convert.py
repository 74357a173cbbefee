"""COLMAP SfM driver (a copy of ``gaussianhaircut_tpu/cli/convert.py``;
reference src/convert.py:32-126): feature extraction -> exhaustive
matching -> mapper -> undistortion to PINHOLE, then the text export to
``sparse_txt/``, by shelling out to the ``colmap`` binary.

    python3 -m gaussianhaircut_torch.cli.convert -s SCENE [--colmap_executable PATH]

It uses no torch and no device: COLMAP runs as its own process."""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run(cmd: str) -> None:
    print("+", cmd)
    rc = subprocess.call(cmd, shell=True)
    if rc != 0:
        print(f"command failed with code {rc}. Exiting.")
        sys.exit(rc)


def main(argv=None):
    parser = argparse.ArgumentParser("convert")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--max_image_size", default=1024, type=int)
    args = parser.parse_args(argv)

    colmap = args.colmap_executable or "colmap"
    if shutil.which(colmap.split()[0]) is None:
        sys.exit("colmap binary not found on PATH; install COLMAP or pass "
                 "--colmap_executable (the rest of the pipeline consumes the "
                 "standard sparse/0 layout it produces)")
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(f"{src}/distorted/sparse", exist_ok=True)
        run(f"{colmap} feature_extractor"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}"
            f" --SiftExtraction.max_image_size {args.max_image_size}")
        run(f"{colmap} exhaustive_matcher"
            f" --database_path {src}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}")
        run(f"{colmap} mapper"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --output_path {src}/distorted/sparse"
            f" --Mapper.ba_global_function_tolerance=0.000001")

    run(f"{colmap} image_undistorter"
        f" --image_path {src}/input"
        f" --input_path {src}/distorted/sparse/0"
        f" --output_path {src}"
        f" --output_type COLMAP")

    sparse0 = f"{src}/sparse/0"
    os.makedirs(sparse0, exist_ok=True)
    for f in os.listdir(f"{src}/sparse"):
        if f == "0":
            continue
        shutil.move(os.path.join(src, "sparse", f), os.path.join(sparse0, f))
    # text export for colmap_parsing (sparse_txt contract)
    os.makedirs(f"{src}/sparse_txt", exist_ok=True)
    run(f"{colmap} model_converter --input_path {sparse0}"
        f" --output_path {src}/sparse_txt --output_type TXT")


if __name__ == "__main__":
    main()
