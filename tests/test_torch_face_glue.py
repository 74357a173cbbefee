"""Parity of the port's on-disk glue for the external face stages with the
JAX package, each package on its own copy of one seeded layout:
``cli/merge_smplx_predictions`` (the concatenated pickle stream, byte for
byte), ``cli/calc_face_alignment`` in its three modes (precomputed
landmarks, an external command, the geometric fallback: ``lmks_2d.pkl`` /
``lmks_3d.pkl`` equal; the visualisations are PNG in the port, JPEG in the
JAX tool) and ``preprocessing/synthetic_scene`` (the same tree, files
byte for byte)."""
import filecmp
import os
import pickle
import shutil
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from gaussianhaircut_tpu.cli import calc_face_alignment as j_cfa
from gaussianhaircut_tpu.cli import merge_smplx_predictions as j_merge
from gaussianhaircut_tpu.preprocessing import synthetic_scene as j_syn
from gaussianhaircut_torch.cli import calc_face_alignment as t_cfa
from gaussianhaircut_torch.cli import merge_smplx_predictions as t_merge
from gaussianhaircut_torch.preprocessing import synthetic_scene as t_syn
from gaussianhaircut_torch.utils.image import read_png


def _twins(tmp_path, build):
    """``build(root)`` under tmp/jax and tmp/port -> the two roots."""
    roots = [str(tmp_path / p) for p in ("jax", "port")]
    for r in roots:
        build(r)
    return roots


def test_merge_smplx_predictions_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = [{"shape": rng.normal(size=(1, 200)).astype(np.float32),
               "pose": rng.normal(size=(1, 55, 3)), "name": f"frame{i}"} for i in range(5)]

    def build(root):
        for i in (3, 0, 4, 1, 2):                       # written out of order
            d = os.path.join(root, "pixie", f"{i:05d}")
            os.makedirs(d)
            with open(os.path.join(d, f"{i:05d}_param.pkl"), "wb") as f:
                pickle.dump(frames[i], f)

    jroot, troot = _twins(tmp_path, build)
    assert j_merge.merge(jroot) == 5
    assert t_merge.main(["--data_path", troot]) == 5
    out = "initialization_pixie"
    assert filecmp.cmp(os.path.join(jroot, out), os.path.join(troot, out), shallow=False)
    back = list(t_merge.read_stream(os.path.join(troot, out)))
    assert [b["name"] for b in back] == [f"frame{i}" for i in range(5)]
    assert [b["name"] for b in j_merge.read_stream(os.path.join(troot, out))] == [
        b["name"] for b in back]


def _face_images(root, rng):
    """Three PNGs, RGB, gray and RGBA, of a skin-toned box on a dark
    background; the last without the box (the centre-square fallback)."""
    d = os.path.join(root, "images")
    os.makedirs(d)
    for i in range(3):
        img = rng.integers(0, 60, (48, 40, 3)).astype(np.uint8)
        if i < 2:
            img[8 + i:40, 6:30 + i] = (200, 140, 110)
        mode = ("RGB", "L", "RGBA")[i]
        im = Image.fromarray(img).convert(mode)
        im.save(os.path.join(d, f"{i:04d}.png"))


def _landmark_dir(root, rng):
    d = os.path.join(root, "lmk")
    os.makedirs(d)
    for i in range(3):
        np.save(os.path.join(d, f"{i:04d}_2d.npy"), rng.uniform(0, 40, (68, 2)))
        if i != 1:                                      # one view without 3D
            np.save(os.path.join(d, f"{i:04d}_3d.npy"), rng.uniform(0, 40, (68, 3)))
    return d


_DETECTOR = textwrap.dedent("""
    import os, sys
    import numpy as np
    img, o2, o3 = sys.argv[1:4]
    seed = sum(os.path.basename(img).encode())
    np.save(o2, np.random.default_rng(seed).uniform(0, 40, (68, 2)))
    if not img.endswith("0002.png"):
        np.save(o3, np.random.default_rng(seed + 1).uniform(0, 40, (68, 3)))
""")


@pytest.mark.parametrize("mode", ["landmarks_dir", "external_cmd", "fallback"])
def test_calc_face_alignment_matches_jax(tmp_path, mode):
    def build(root):
        rng = np.random.default_rng(1)
        _face_images(root, rng)
        _landmark_dir(root, rng)

    jroot, troot = _twins(tmp_path, build)
    script = tmp_path / "detector.py"
    script.write_text(_DETECTOR)
    for root, main in ((jroot, j_cfa.main), (troot, t_cfa.main)):
        argv = ["--data_path", root]
        if mode == "landmarks_dir":
            argv += ["--landmarks_dir", os.path.join(root, "lmk")]
        elif mode == "external_cmd":
            argv += ["--external_cmd", f"{sys.executable} {script}"]
        main(argv)
    for name in ("lmks_2d.pkl", "lmks_3d.pkl"):
        with open(os.path.join(jroot, "face_alignment", name), "rb") as f:
            ref = pickle.load(f)
        with open(os.path.join(troot, "face_alignment", name), "rb") as f:
            got = pickle.load(f)
        assert sorted(got) == sorted(ref) and got, name
        for k in ref:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name} {k}")
    for kind in ("vis_2d", "vis_3d"):
        jfiles = sorted(os.listdir(os.path.join(jroot, "face_alignment", kind)))
        tfiles = sorted(os.listdir(os.path.join(troot, "face_alignment", kind)))
        assert [f[:-4] for f in tfiles] == [f[:-4] for f in jfiles]
        assert all(f.endswith(".png") for f in tfiles) and all(f.endswith(".jpg") for f in jfiles)
        for f in tfiles:
            vis = read_png(os.path.join(troot, "face_alignment", kind, f))
            assert vis.shape == (48, 40, 3) and (vis == (0, 255, 0)).all(-1).any()


def test_calc_face_alignment_refuses_other_formats(tmp_path):
    os.makedirs(tmp_path / "images")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "images" / "0000.jpg")
    with pytest.raises(NotImplementedError, match="PNG"):
        t_cfa.main(["--data_path", str(tmp_path), "--no_vis"])


def test_synthetic_scene_matches_jax(tmp_path):
    src = tmp_path / "dump"
    rng = np.random.default_rng(2)
    for sub in ("image", "hair_mask", "mask", "orientation_maps", "confidence_maps"):
        os.makedirs(src / sub)
        for i in range(2):
            (src / sub / f"{i}.png").write_bytes(rng.bytes(64))
    for f in ("cameras.npz", "projection.npy", "point_cloud.ply"):
        (src / f).write_bytes(rng.bytes(32))
    dst = {}
    for pkg, fn in (("jax", j_syn.preprocess_synthetic_scene), ("port", None)):
        dst[pkg] = tmp_path / pkg
        if fn is None:
            t_syn.main(["--src", str(src), "--dst", str(dst[pkg])])
        else:
            fn(str(src), str(dst[pkg]))

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(dst["port"]) == tree(dst["jax"]) and len(tree(dst["jax"])) == 13
    for rel in tree(dst["jax"]):
        assert filecmp.cmp(dst["jax"] / rel, dst["port"] / rel, shallow=False), rel
    # an existing target directory is kept as it is
    shutil.rmtree(src / "image")
    t_syn.preprocess_synthetic_scene(str(src), str(dst["port"]))
    assert tree(dst["port"]) == tree(dst["jax"])
