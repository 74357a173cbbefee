"""End-to-end pipeline orchestrator, the run.sh equivalent (port of
``gaussianhaircut_tpu/cli/run_pipeline.py``; reference run.sh:1-233).

    python3 -m gaussianhaircut_torch.cli.run_pipeline --data_path SCENE [--device cpu]

The same stages, flags and on-disk checks as the JAX orchestrator; the
internal stages call the port's modules: filter and resize, Gabor
orientation maps, colmap_to_h3ds, stage 1, the sphere crop and FLAME
filter, the synthetic-GT export, stages 2 and 3, export_curves and
render_strands.  The stages whose tools are external networks (masks,
OpenPose, PIXIE, FLAME fitting, scalp) are pluggable: the orchestrator
checks for their outputs and, when ``--external_cmds`` gives a command for
the stage, shells out to it.  ``--device`` goes to every stage (CUDA by
default).  Decoding ``raw.mp4`` into frames is not ported
(``preprocessing.frames.extract_frames`` raises).

Environment variables as run.sh: DATA_PATH (the scene directory), EXP_NAME.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

_DONE = ("=== ", ": done ===")      # the line around a finished stage's name


def done_line(stage: str) -> str:
    """The line printed when ``stage`` has finished."""
    return f"{_DONE[0]}{stage}{_DONE[1]}"


def stages_done(text: str) -> list[str]:
    """The stages whose ``done_line`` is in ``text``, in order."""
    return re.findall(re.escape(_DONE[0]) + r"(\S+)" + re.escape(_DONE[1]), text)


def _have(path: str) -> bool:
    return os.path.exists(path)


def _external(stage: str, cmds: dict, env: dict) -> bool:
    if stage in cmds:
        cmd = cmds[stage].format(**env)
        print(f"[external:{stage}] {cmd}")
        rc = subprocess.call(cmd, shell=True)
        if rc != 0:
            sys.exit(f"external stage {stage} failed with code {rc}")
        return True
    return False


def main(argv=None):
    from gaussianhaircut_torch.device import resolve_device

    parser = argparse.ArgumentParser("run_pipeline")
    parser.add_argument("--data_path", default=os.environ.get("DATA_PATH", ""))
    parser.add_argument("--exp_name", default=os.environ.get("EXP_NAME", "stage1"))
    parser.add_argument("--exp_name_2", default="stage2")
    parser.add_argument("--exp_name_3", default="stage3")
    parser.add_argument("--external_cmds", default="",
                        help="json file mapping stage name -> shell command "
                             "(masks, openpose, pixie, flame_fitting)")
    parser.add_argument("--stop_after", default="", help="stop after this stage")
    parser.add_argument("--max_frames", type=int, default=128)
    parser.add_argument("--iters1", type=int, default=30000,
                        help="stage-1 iterations (run.sh:112)")
    parser.add_argument("--iters2", type=int, default=20000,
                        help="stage-2 iterations (run.sh:180)")
    parser.add_argument("--iters3", type=int, default=10000,
                        help="stage-3 iterations (run.sh:195)")
    parser.add_argument("--extra_train_args", default="",
                        help="space-separated extra flags appended to every trainer CLI")
    parser.add_argument("--extra_strand_args", default="",
                        help="space-separated extra flags for the stage-2/3 trainers only "
                        "(num_strands/texture_size/...)")
    parser.add_argument("--skip_preprocessing", action="store_true")
    parser.add_argument("--prior_checkpoint", default=os.environ.get("PRIOR_CKPT", ""),
                        help="a strand-prior npz; enables L_diff (stage 2) and SDS "
                        "(stage 3) with a pretrained prior")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device for every stage; default cuda (cpu runs the "
                        "plain PyTorch path)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if not args.data_path:
        sys.exit("--data_path (or DATA_PATH) required")
    data = os.path.abspath(args.data_path)
    cmds = {}
    if args.external_cmds:
        with open(args.external_cmds) as f:
            cmds = json.load(f)
    env = dict(DATA_PATH=data, EXP_NAME=args.exp_name)
    dev = ["--device", str(device)]

    model_path = os.path.join(data, "3d_gaussian_splatting", args.exp_name)
    hair_path = os.path.join(data, "strands_reconstruction", args.exp_name_2)
    curves_path = os.path.join(data, "curves_reconstruction", args.exp_name_3)
    flame_dir = os.path.join(data, "flame_fitting", args.exp_name)

    def done(stage):
        print(done_line(stage), flush=True)
        if args.stop_after == stage:
            sys.exit(0)

    # --- 1. frames (run.sh:15-20) ---
    if not args.skip_preprocessing:
        from gaussianhaircut_torch.preprocessing.frames import extract_frames
        if not _have(os.path.join(data, "input")) and _have(os.path.join(data, "raw.mp4")):
            extract_frames(os.path.join(data, "raw.mp4"), os.path.join(data, "input"))
        done("frames")

        # --- 2. COLMAP (run.sh:25-33) ---
        if not _have(os.path.join(data, "sparse/0")):
            if not _external("colmap", cmds, env):
                from gaussianhaircut_torch.cli import convert
                convert.main(["-s", data])
        done("colmap")

        # --- 3. masks (run.sh:35-39, external Matte-Anything env) ---
        if not _have(os.path.join(data, "masks")):
            if not _external("masks", cmds, env):
                sys.exit("masks/ missing: provide an external 'masks' command "
                         "(Matte-Anything) in --external_cmds, or precompute "
                         "masks/{hair,face,body}")
        done("masks")

        # --- 4. filter + resize (run.sh:41-50) ---
        from gaussianhaircut_torch.preprocessing.frames import filter_extra_images
        from gaussianhaircut_torch.preprocessing.scene_tools import resize_images
        if not _have(os.path.join(data, "images_2")):
            filter_extra_images(data, max_imgs=args.max_frames, device=device)
            resize_images(data, device=device)
        done("resize")

        # --- 5. orientation maps (run.sh:52-58) ---
        if not _have(os.path.join(data, "orientations_2")):
            from gaussianhaircut_torch.preprocessing import orientation_maps
            orientation_maps.main([
                "--img_path", f"{data}/images_2",
                "--mask_path", f"{data}/masks_2/hair",
                "--orient_dir", f"{data}/orientations_2/angles",
                "--conf_dir", f"{data}/orientations_2/vars",
                "--filtered_img_dir", f"{data}/orientations_2/filtered",
                "--vis_img_dir", f"{data}/orientations_2/vis"] + dev)
        done("orientations")

        # --- 6. keypoints / face fitting inputs (run.sh:60-102, external) ---
        for stage in ("openpose", "face_alignment", "pixie"):
            _external(stage, cmds, env)
        from gaussianhaircut_torch.preprocessing.scene_tools import colmap_to_h3ds
        if _have(os.path.join(data, "sparse_txt")) and not _have(
                os.path.join(data, "cameras.npz")):
            colmap_to_h3ds(data)
        done("parsing")

    extra = args.extra_train_args.split() if args.extra_train_args else []
    extra_s = extra + args.extra_strand_args.split() if args.extra_strand_args else extra

    # --- 7. stage 1 (run.sh:110-115) ---
    if not _have(os.path.join(model_path, "point_cloud")):
        from gaussianhaircut_torch.cli import train_gaussians
        train_gaussians.main(["-s", data, "-m", model_path,
                              "--lambda_dorient", "0.1",
                              "--iterations", str(args.iters1),
                              "--save_iterations", str(args.iters1),
                              "--checkpoint_iterations", str(args.iters1)] + extra + dev)
    done("stage1")

    # --- 8. FLAME fitting (run.sh:117-139, external NeuralHaircut) ---
    _external("flame_fitting", cmds, env)
    done("flame")

    # --- 9. crop + filter (run.sh:141-153) ---
    from gaussianhaircut_torch.cli.render_gaussians import find_max_iteration
    from gaussianhaircut_torch.preprocessing.scene_tools import (
        filter_flame_intersections, scale_scene_into_sphere)
    it1 = find_max_iteration(model_path)
    if not _have(os.path.join(data, "scale.pickle")):
        scale_scene_into_sphere(model_path, data, it1, device=device)
    flame_mesh = os.path.join(flame_dir, "stage_3", "mesh_final.obj")
    if _have(flame_mesh) and not _have(os.path.join(model_path, "point_cloud_filtered")):
        filter_flame_intersections(model_path, flame_mesh, it1, device=device)
    done("crop")

    # --- 10. synthetic GT export (run.sh:156-159) ---
    from gaussianhaircut_torch.cli import render_gaussians
    if not _have(os.path.join(model_path, "train_cropped")):
        render_gaussians.main(["-s", data, "-m", model_path,
                               "--scene_suffix", "_cropped", "--skip_test"] + dev)
    done("render_gaussians")

    # --- 11. scalp extraction (run.sh:161-167) ---
    _external("scalp", cmds, env)

    # --- 12/13. stages 2 + 3 (run.sh:169-195) ---
    from gaussianhaircut_torch.cli import train_latent_strands, train_strands
    prior_args = ["--prior_checkpoint", args.prior_checkpoint] if args.prior_checkpoint else []
    if not _have(os.path.join(hair_path, "checkpoints")):
        train_latent_strands.main([
            "-s", data, "-m", model_path, "--model_path_hair", hair_path,
            "--flame_mesh_dir", flame_dir,
            "--lambda_dmask", "0.1", "--lambda_dorient", "0.1",
            "--lambda_dsds", "0.01", "--iterations", str(args.iters2),
            "--checkpoint_iterations", str(args.iters2),
            "--iteration_data", str(args.iters1),
            "--use_diffusion",
            "--load_synthetic_rgba", "--load_synthetic_geom"]
            + prior_args + extra_s + dev)
    done("stage2")
    if not _have(os.path.join(curves_path, "checkpoints")):
        ck2 = os.path.join(hair_path, "checkpoints", f"{args.iters2}.npz")
        train_strands.main([
            "-s", data, "-m", model_path, "--model_path_hair", hair_path,
            "--model_path_curves", curves_path, "--flame_mesh_dir", flame_dir,
            "--start_checkpoint_hair", ck2,
            "--lambda_dmask", "0.1", "--lambda_dorient", "0.1",
            "--lambda_dsds", "0.01", "--iterations", str(args.iters3),
            "--checkpoint_iterations", str(args.iters3),
            "--iteration_data", str(args.iters1),
            "--use_sds"] + prior_args + extra_s + dev)
    done("stage3")

    # --- 14. export + renders (run.sh:199-233) ---
    from gaussianhaircut_torch.cli import export_curves, render_strands
    export_curves.main(["--data_dir", data, "--model_name", args.exp_name_3,
                        "--iter", str(args.iters3)] + dev)
    render_strands.main([
        "-s", data, "-m", model_path, "--model_hair_path", hair_path,
        "--checkpoint_curves", os.path.join(curves_path, "checkpoints", f"{args.iters3}.npz"),
        "--skip_test"] + extra + dev)
    _external("blender_video", cmds, env)
    done("export")


if __name__ == "__main__":
    main()
