"""The JAX package trains on the scene files the port's orchestrator
wrote: ``run_pipeline --device cpu`` up to the synthetic-GT export on the
toy scene of ``test_torch_pipeline.py``, then the JAX ``render_gaussians``
renders the port's ``point_cloud_cropped``, its stage-2 CLI trains on the
port's ``images_2``, ``masks_2``, ``orientations_2``, ``scale.pickle`` and
filtered head, and its stage-3 CLI on those renders (one iteration each,
``jnp`` rasterizer)."""
import os
import sys

import numpy as np
import pytest

from gaussianhaircut_tpu.cli import render_gaussians as j_render_gaussians
from gaussianhaircut_tpu.cli import train_latent_strands as j_s2
from gaussianhaircut_tpu.cli import train_strands as j_s3
from gaussianhaircut_torch.cli import run_pipeline
from gaussianhaircut_torch.scene.synthetic import toy_pipeline_scene

TRAIN = "--tile 16 --gaussian_capacity 512 --test_iterations -1"
STRANDS = "--num_strands 8 --texture_size 16 --strand_length 8 --diffusion_input 4"


def test_jax_reads_the_ports_scene(tmp_path, monkeypatch):
    """The port's orchestrator up to the synthetic GT; then the JAX
    render_gaussians of the cropped cloud writes one render per view, and
    the JAX stage 2 and stage 3 train one step each from the port's files
    to finite checkpoints."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    d = str(tmp_path / "scene")
    toy_pipeline_scene(d)
    with pytest.raises(SystemExit) as stop:
        run_pipeline.main(["--data_path", d, "--device", "cpu", "--iters1", "3",
                           "--extra_train_args", TRAIN, "--stop_after", "crop"])
    assert stop.value.code == 0
    model = f"{d}/3d_gaussian_splatting/stage1"
    j_render_gaussians.main(["-s", d, "-m", model, "--scene_suffix", "_cropped",
                             "--skip_test", "--raster_backend", "jnp", "--tile", "16"])
    assert len(os.listdir(f"{model}/train_cropped/ours_3/renders")) == 3
    common = (["-s", d, "-m", model, "--raster_backend", "jnp", "--iterations", "1",
               "--checkpoint_iterations", "1", "--iteration_data", "3",
               "--flame_mesh_dir", f"{d}/flame_fitting/stage1", "--lambda_dmask", "0.1",
               "--lambda_dorient", "0.1"] + TRAIN.split() + STRANDS.split())
    hair, curves = f"{d}/hair_jax", f"{d}/curves_reconstruction/jax"
    # stage 2 on the port's images_2, masks_2 and orientations_2; stage 3 on
    # the JAX renders of the port's cropped cloud
    j_s2.main(common + ["--model_path_hair", hair])
    j_s3.main(common + ["--model_path_hair", hair, "--model_path_curves", curves,
                        "--start_checkpoint_hair", f"{hair}/checkpoints/1.npz",
                        "--load_synthetic_rgba", "--load_synthetic_geom"])
    with np.load(f"{curves}/checkpoints/1.npz") as z:
        assert all(np.isfinite(z[k]).all() for k in z.files)
