"""Parity of the port's evaluation and export tools with the JAX
package's on the CPU:

- ``ops/lpips``: ``synthesize_weights`` bit-identical, the distance per
  pair at rtol 1e-4 (odd sizes, batched), the kind labels;
- ``cli/metrics``: ``results.json`` and ``per_view.json`` with the same
  keys and values at rtol 1e-4 over PNGs the port wrote (RGB, RGBA and
  gray), the untrained LPIPS keyed ``LPIPS[untrained-seeded]``;
- ``cli/export_strands``: from one stage-2 checkpoint, given the JAX
  export's root draw, the points within atol 1e-5 and the same strands
  pruned by the head (a 480-face sphere)."""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.cli import export_strands as j_export
from gaussianhaircut_tpu.cli import metrics as j_metrics
from gaussianhaircut_tpu.models.textured_strands import ScalpPool as JScalpPool
from gaussianhaircut_tpu.models.textured_strands import TexturedStrandsConfig as JConfig
from gaussianhaircut_tpu.ops import lpips as j_lpips
from gaussianhaircut_tpu.train import stage2 as j_stage2
from gaussianhaircut_torch.cli import export_strands, metrics
from gaussianhaircut_torch.ops import lpips
from gaussianhaircut_torch.scene.synthetic import cap_mesh, sphere_mesh
from gaussianhaircut_torch.utils import mesh as mesh_util
from gaussianhaircut_torch.utils.image import write_png

RTOL = 1e-4


def test_synthesized_weights_are_the_jax_packages():
    a, b = lpips.synthesize_weights(3), j_lpips.synthesize_weights(3)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_lpips_matches_jax(rng):
    blob = lpips.synthesize_weights(seed=1)
    ours = lpips.LPIPS(weights=blob, device="cpu")
    ref = j_lpips.LPIPS(weights=blob)
    assert ours.kind == ref.kind == "untrained-seeded"
    a = rng.uniform(size=(2, 3, 33, 47)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = ours(a, b).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(a, b)), rtol=RTOL)
    np.testing.assert_allclose(float(ours(a[1], b[1])), float(ref(a[1], b[1])), rtol=RTOL)
    assert float(ours(a[0], a[0])) == 0.0 and (got > 0).all()


def test_lpips_or_none_labels_the_backbone(tmp_path):
    missing = str(tmp_path / "missing.npz")
    assert lpips.lpips_or_none(missing, device="cpu") is None
    assert lpips.lpips_or_none(missing, allow_untrained=True, device="cpu").kind == \
        "untrained-seeded"
    blob = dict(lpips.synthesize_weights(2))
    blob.pop("kind")
    np.savez(tmp_path / "w.npz", **blob)
    assert lpips.lpips_or_none(str(tmp_path / "w.npz"), device="cpu").kind == "pretrained"


def _eval_dir(rng, model):
    """test/ours/{renders,gt} of 3 views in RGB, RGBA and gray, written by
    the port's PNG writer; a method without gt is skipped."""
    for sub in ("renders", "gt"):
        os.makedirs(os.path.join(model, "test", "ours", sub))
    os.makedirs(os.path.join(model, "test", "empty", "renders"))
    for i, ch in enumerate((3, 4, 1)):
        gt = rng.integers(0, 256, (40, 56, ch)).astype(np.uint8)
        noisy = np.clip(gt.astype(int) + rng.integers(-30, 31, gt.shape), 0, 255)
        write_png(os.path.join(model, "test", "ours", "gt", f"{i}.png"), gt)
        write_png(os.path.join(model, "test", "ours", "renders", f"{i}.png"),
                  noisy.astype(np.uint8))


def test_metrics_match_jax(rng, tmp_path, monkeypatch):
    monkeypatch.setenv("GHT_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setattr(j_lpips, "_DEFAULT_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setattr(lpips, "_DEFAULT_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setattr(j_lpips, "_cached", {})
    model = str(tmp_path / "model")
    _eval_dir(rng, model)
    results = {}
    for pkg, evaluate in (("jax", lambda: j_metrics.evaluate([model])),
                          ("port", lambda: metrics.main(["-m", model, "--device", "cpu"]))):
        results[pkg] = evaluate()
        with open(os.path.join(model, "results.json")) as f, \
                open(os.path.join(model, "per_view.json")) as g:
            results[pkg] = (json.load(f), json.load(g))
    (res_p, per_p), (res_j, per_j) = results["port"], results["jax"]
    assert sorted(res_p) == sorted(res_j) == ["ours"]
    assert sorted(res_p["ours"]) == sorted(res_j["ours"]) == sorted(
        ["SSIM", "PSNR", "LPIPS[untrained-seeded]", "LPIPS_kind"])
    assert res_p["ours"]["LPIPS_kind"] == res_j["ours"]["LPIPS_kind"] == "untrained-seeded"
    for k in ("SSIM", "PSNR", "LPIPS[untrained-seeded]"):
        np.testing.assert_allclose(res_p["ours"][k], res_j["ours"][k], rtol=RTOL)
        assert sorted(per_p["ours"][k]) == sorted(per_j["ours"][k]) == ["0.png", "1.png",
                                                                        "2.png"]
        for name, v in per_j["ours"][k].items():
            np.testing.assert_allclose(per_p["ours"][k][name], v, rtol=RTOL)


@pytest.fixture(scope="module")
def export_scene(tmp_path_factory):
    """A stage-2 checkpoint (the JAX initialisation, texture 16, full
    strand length) and a FLAME directory: a sphere as the head and the cap
    of another as the scalp."""
    root = str(tmp_path_factory.mktemp("export"))
    cfg = JConfig(num_strands=40, texture_size=16)
    state = j_stage2.init_hair_state(cfg, jax.random.PRNGKey(3))
    j_stage2.save_checkpoint(state, os.path.join(
        root, "strands_reconstruction", "hair", "checkpoints", "5.npz"))
    flame = os.path.join(root, "flame")
    os.makedirs(os.path.join(flame, "stage_3"))
    os.makedirs(os.path.join(flame, "scalp_data"))
    # the head is shifted off the scalp's sphere, so that the roots lie
    # clearly inside or outside it, not on its surface
    head = sphere_mesh((0.05, 0.05, 0.0), 0.1, n_lat=16, n_lon=16)
    mesh_util.save_obj(os.path.join(flame, "stage_3", "mesh_final.obj"), head.verts, head.faces)
    scalp = cap_mesh(sphere_mesh((0.0, 0.05, 0.0), 0.1), (0.0, 0.05, 0.0))
    mesh_util.save_obj(os.path.join(flame, "scalp_data", "scalp.obj"), scalp.verts,
                       scalp.faces)
    pool = JScalpPool.from_flame_dir(flame, root, cfg)
    roots = np.array(jax.random.choice(jax.random.PRNGKey(7), pool.origins.shape[0],
                                         (cfg.num_strands,), replace=False))
    return root, flame, roots


def _exported(root, name):
    with open(os.path.join(root, "strands_reconstruction", name, "strands", "5_strands.pkl"),
              "rb") as f:
        return pickle.load(f)


def test_export_strands_matches_jax(export_scene):
    """Both exports from one checkpoint with the JAX draw of roots: the
    same strands pruned and the kept points within atol 1e-5."""
    root, flame, roots = export_scene
    argv = ["--data_dir", root, "--model_name", "hair", "--flame_mesh_dir", flame,
            "--iter", "5", "--num_strands", "40", "--texture_size", "16"]
    j_export.main(argv)
    ref = _exported(root, "hair")
    out = export_strands.export(root, "hair", flame, "5", 40, 16, roots=roots, device="cpu")
    pts = _exported(root, "hair")
    assert 0 < out["keep"].sum() < 40 and out["sdf_terms"] == 40 * 100 * 480
    assert pts.shape == ref.shape == (int(out["keep"].sum()), 100, 3)
    np.testing.assert_allclose(pts, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["points"], pts)


def test_export_strands_cli_draws_its_own_roots(export_scene):
    root, flame, _ = export_scene
    out = export_strands.main(["--data_dir", root, "--model_name", "hair", "--iter", "5",
                               "--num_strands", "40", "--texture_size", "16",
                               "--device", "cpu"])
    assert out["keep"].all() and out["sdf_terms"] == 0          # no head: no pruning
    pts = _exported(root, "hair")
    assert pts.shape == (40, 100, 3) and np.isfinite(pts).all()
    assert torch.equal(torch.as_tensor(pts), torch.as_tensor(out["points"]))
