"""Cycles strand renderer — runs INSIDE Blender (>= 3.6); a copy of
``gaussianhaircut_tpu/postprocessing/blender_render_script.py`` that
``postprocessing/video.blender_render`` hands to Blender:

    blender -b -P blender_render_script.py -- <inputs_dir> <out_dir>

The in-Blender counterpart of the reference's render_color.py: builds a
camera from each exported world-to-camera matrix, imports the head PLY and
the strand polylines (pkl of [N, L, 3]) as hair curve objects with a simple
principled material, and renders each view with Cycles.

This file imports bpy (and numpy) only inside ``main``, which runs inside
Blender; the rest of the package never imports it.
"""
import os
import pickle
import sys


def main():
    import bpy  # only available inside Blender
    import numpy as np

    argv = sys.argv[sys.argv.index("--") + 1:]
    inputs_dir, out_dir = argv[0], argv[1]
    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(inputs_dir, "cameras.pkl"), "rb") as f:
        cameras = pickle.load(f)
    paths = dict(line.strip().split("=", 1)
                 for line in open(os.path.join(inputs_dir, "inputs.txt")))

    bpy.ops.wm.read_factory_settings(use_empty=True)
    scene = bpy.context.scene
    scene.render.engine = "CYCLES"

    # head mesh
    bpy.ops.wm.ply_import(filepath=paths["head"])
    head = bpy.context.selected_objects[0]
    mat = bpy.data.materials.new("head")
    mat.use_nodes = True
    head.data.materials.append(mat)

    # strands as polyline curves
    with open(paths["strands"], "rb") as f:
        strands = pickle.load(f)
    curve_data = bpy.data.curves.new("hair", type="CURVE")
    curve_data.dimensions = "3D"
    curve_data.bevel_depth = 0.0008
    for strand in strands[:30000]:
        sp = curve_data.splines.new("POLY")
        sp.points.add(len(strand) - 1)
        for p, xyz in zip(sp.points, strand):
            p.co = (float(xyz[0]), float(xyz[1]), float(xyz[2]), 1.0)
    hair_obj = bpy.data.objects.new("hair", curve_data)
    scene.collection.objects.link(hair_obj)
    hmat = bpy.data.materials.new("hairmat")
    hmat.use_nodes = True
    hair_obj.data.materials.append(hmat)

    # sun + ambient
    sun = bpy.data.objects.new("sun", bpy.data.lights.new("sun", "SUN"))
    scene.collection.objects.link(sun)

    cam_data = bpy.data.cameras.new("cam")
    cam_obj = bpy.data.objects.new("cam", cam_data)
    scene.collection.objects.link(cam_obj)
    scene.camera = cam_obj

    for name, params in cameras.items():
        rt = np.asarray(params["Rt"])  # [4,4] world->cam (column-vector)
        c2w = np.linalg.inv(rt)
        flip = np.diag([1, -1, -1, 1])  # COLMAP -> Blender camera axes
        m = c2w @ flip
        cam_obj.matrix_world = [list(row) for row in m]
        w, h = int(params["width"]), int(params["height"])
        scene.render.resolution_x = w
        scene.render.resolution_y = h
        cam_data.lens = params["fx"] / w * cam_data.sensor_width
        scene.render.filepath = os.path.join(out_dir, f"{name}.png")
        bpy.ops.render.render(write_still=True)


if __name__ == "__main__":
    main()
