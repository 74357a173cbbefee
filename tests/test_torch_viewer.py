"""The port's live viewer (``render/network_gui.py``, ``train/stage1.
poll_gui`` and ``cli/train_gaussians --gui``) against the JAX package's:

- the loopback round trip of tests/test_network_gui.py: a fake SIBR viewer
  sends one 32x32 camera in the reference wire format (the matrices of a
  camera that sees the Gaussians); the reply bytes of
  the port's ``poll_gui`` are within one level of JAX ``poll_gui``'s on the
  same state (carried across with ``state_from_numpy``; the JAX side on its
  ``jnp`` rasterizer) and equal to the port's ``render()`` of that camera;
- ``train()`` polls the viewer at the top of each iteration: a viewer that
  sends one request per iteration (the last one with ``keep_alive``, which
  holds the trainer until the viewer lets it go) gets every reply and the
  training finishes;
- ``train_gaussians --gui`` on a written scene for two iterations with a
  viewer thread.

Every socket read of the fake viewer has a timeout, so a fault fails the
test instead of hanging it; the listener is closed after each test."""
import json
import os
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from gaussianhaircut_tpu.config import ModelConfig as JModelConfig
from gaussianhaircut_tpu.models import gaussian_model as j_gm
from gaussianhaircut_tpu.ops.rasterize import RasterConfig as JRasterConfig
from gaussianhaircut_tpu.render import network_gui as j_gui
from gaussianhaircut_tpu.train import stage1 as j_stage1
from gaussianhaircut_torch.cli import train_gaussians as t_train
from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gaussianhaircut_torch.models import gaussian_model as gm
from gaussianhaircut_torch.ops.rasterize.common import RasterConfig
from gaussianhaircut_torch.render import network_gui
from gaussianhaircut_torch.render.renderer import default_background, render
from gaussianhaircut_torch.scene.cameras import camera_geom
from gaussianhaircut_torch.scene.synthetic import bench_scene, write_colmap_scene
from gaussianhaircut_torch.train import stage1

TIMEOUT = 60.0          # seconds any read of the fake viewer may wait
RES, FOV = 32, 0.8


def viewer_message(width, height, world_view, full_proj, fov, do_training=1, keep_alive=0,
                   scaling=1.0):
    """One request in the SIBR viewer's wire format (network_gui.py:57-78)."""
    extra = json.dumps({"fov_x": fov, "fov_y": fov}).encode()
    body = struct.pack("II", width, height)
    body += struct.pack("bbbb", do_training, 0, 0, keep_alive)
    body += struct.pack("f", scaling)
    body += np.asarray(world_view, np.float32).tobytes()
    body += np.asarray(full_proj, np.float32).tobytes()
    body += struct.pack("I", len(extra)) + extra
    return struct.pack("I", len(body)) + body


def read_reply(sock, nbytes):
    """The image bytes (``nbytes`` of them) and the source path of one
    reply."""
    def exact(n):
        out = b""
        while len(out) < n:
            chunk = sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("server closed")
            out += chunk
        return out
    image = exact(nbytes)
    n = struct.unpack("<I", exact(4))[0]
    return image, exact(n).decode()


def matrices(distance=2.0):
    """The JAX test's camera, 2 units from the origin: its view and full
    projection matrices (row-vector) as a SIBR viewer sends them, made by
    ``camera_geom`` (the JAX test's hand-made projection puts w on the
    wrong row and renders an empty image)."""
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = distance
    fov = torch.tensor(FOV)
    geom = camera_geom(torch.tensor(w2c), fov, fov, RES, RES)
    return geom.viewmatrix.numpy(), geom.projmatrix.numpy()


def connect(listener):
    sock = socket.create_connection(("127.0.0.1", listener.getsockname()[1]), timeout=TIMEOUT)
    sock.settimeout(TIMEOUT)
    return sock


@pytest.fixture
def close_listeners():
    yield
    for mod in (network_gui, j_gui):
        if mod.conn is not None:
            mod.conn.close()
        if mod.listener is not None:
            mod.listener.close()
        mod.listener = mod.conn = None


def _reply(gui, poll, msg):
    gui.init("127.0.0.1", 0)
    client = connect(gui.listener)
    try:
        client.sendall(msg)
        poll()
        return read_reply(client, RES * RES * 3)
    finally:
        client.close()


def test_round_trip_matches_jax(tmp_path, close_listeners):
    rng = np.random.default_rng(0)
    pts = rng.normal(scale=0.3, size=(64, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (64, 3)).astype(np.float32)
    jstate = j_stage1.init_train_state(j_gm.create_from_pcd(pts, cols, 64, 0, 1.0), 1,
                                       use_barf=True)
    d = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()}
    model = gm.state_from_numpy(d(jstate.model.params), d(jstate.model.aux), 0, 0, 1.0, "cpu")
    tstate = stage1.init_train_state(model, 1, use_barf=True)
    viewmatrix, full_proj = matrices()
    msg = viewer_message(RES, RES, viewmatrix, full_proj, FOV)

    jcfg = JModelConfig()
    jcfg.source_path, jcfg.white_background = str(tmp_path), False
    jraster = JRasterConfig(tile_w=16, tile_h=16, chunk=32, capacity_mult=32, backend="jnp")
    ref, ref_src = _reply(j_gui, lambda: j_stage1.poll_gui(jstate, jcfg, jraster, 0, 1, 10), msg)
    cfg = ModelConfig(source_path=str(tmp_path), white_background=False)
    raster = RasterConfig(tile_w=16, tile_h=16, chunk=32)
    got, got_src = _reply(network_gui, lambda: stage1.poll_gui(tstate, cfg, raster, 0, 1, 10),
                          msg)
    assert got_src == ref_src == str(tmp_path)
    a = np.frombuffer(got, np.uint8).reshape(RES, RES, 3).astype(int)
    b = np.frombuffer(ref, np.uint8).reshape(RES, RES, 3).astype(int)
    assert a.max() > 0 and np.abs(a - b).max() <= 1, np.abs(a - b).max()

    cam = stage1.gui_camera(dict(width=RES, height=RES, world_view_transform=viewmatrix,
                                 full_proj_transform=full_proj, fovx=FOV, fovy=FOV), "cpu")
    with torch.no_grad():
        img = render(model.params, model.aux.alive, 0, cam, default_background(False, "cpu"),
                     raster)["render"]
    want = (img.clamp(0, 1) * 255).to(torch.uint8).permute(1, 2, 0).numpy()
    np.testing.assert_array_equal(a, want)


def test_no_listener_returns_at_once(close_listeners):
    assert network_gui.listener is None
    stage1.poll_gui(None, None, None, 0, 1, 1)      # touches nothing


def _scene(rng, n_views=1):
    from gaussianhaircut_torch.scene.cameras import CameraStatic
    import types
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.0
    cams = []
    for i in range(n_views):
        cam = CameraStatic(uid=i, colmap_id=i, image_name=str(i), width=RES, height=RES,
                           colmap_transform=w2c, fovx=FOV, fovy=FOV)
        cam.image = rng.uniform(size=(3, RES, RES)).astype(np.float32)
        cam.mask_hair = np.ones((1, RES, RES), np.float32)
        cam.mask_body = np.ones((1, RES, RES), np.float32)
        cam.orient_angle = rng.uniform(size=(1, RES, RES)).astype(np.float32)
        cam.orient_conf = np.ones((1, RES, RES), np.float32)
        cams.append(cam)
    return types.SimpleNamespace(
        train_cameras=cams, points=rng.normal(scale=0.3, size=(80, 3)).astype(np.float32),
        colors=rng.uniform(size=(80, 3)).astype(np.float32), cameras_extent=1.0)


def _viewer(sock, plan, replies, errors):
    """A fake viewer on a connected socket: sends the requests of ``plan``
    ((width, keep_alive) each; width 0 asks for no image) one at a time,
    reading each reply before the next request."""
    viewmatrix, full_proj = matrices()
    try:
        for width, keep_alive in plan:
            sock.sendall(viewer_message(width, width, viewmatrix, full_proj, FOV,
                                        keep_alive=keep_alive))
            replies.append(read_reply(sock, width * width * 3))
    except Exception as e:          # reported by the test
        errors.append(e)
    finally:
        sock.close()


def test_train_answers_the_viewer_each_iteration(tmp_path, close_listeners):
    """Three iterations with a viewer: images at iterations 1 and 3, none at
    2; at the last iteration ``keep_alive`` holds the trainer for one more
    request.  Each reply is the render of the state before that iteration."""
    rng = np.random.default_rng(1)
    scene = _scene(rng)
    network_gui.init("127.0.0.1", 0)
    plan = [(RES, 0), (0, 0), (RES, 1), (RES, 0)]
    replies, errors, states = [], [], {}
    # connected before train() starts: the first poll accepts it
    thread = threading.Thread(target=_viewer, args=(connect(network_gui.listener), plan,
                                                    replies, errors), daemon=True)
    thread.start()

    def snapshot(it, st, m):
        states[it] = (gm.GaussianParams(*(v.detach().clone() for v in st.model.params.values())),
                      st.model.aux.alive.clone())

    stage1.train(ModelConfig(sh_degree=0, source_path="src"),
                 OptimizationConfig(iterations=3), PipelineConfig(gaussian_capacity=128, tile=16),
                 scene, device="cpu", progress_callback=snapshot)
    thread.join(TIMEOUT)
    assert not thread.is_alive() and not errors, errors
    assert [len(r[0]) for r in replies] == [RES * RES * 3, 0, RES * RES * 3, RES * RES * 3]
    assert all(src == "src" for _, src in replies)
    viewmatrix, full_proj = matrices()
    cam = stage1.gui_camera(dict(width=RES, height=RES, world_view_transform=viewmatrix,
                                 full_proj_transform=full_proj, fovx=FOV, fovy=FOV), "cpu")
    for reply, after in ((replies[2], 2), (replies[3], 2)):
        params, alive = states[after]
        with torch.no_grad():
            img = render(params, alive, 0, cam, default_background(False, "cpu"),
                         RasterConfig(tile_w=16, tile_h=16))["render"]
        want = (img.clamp(0, 1) * 255).to(torch.uint8).permute(1, 2, 0).numpy().tobytes()
        assert reply[0] == want


def test_train_gaussians_gui_serves_a_viewer(tmp_path, close_listeners, monkeypatch):
    """The viewer connects as soon as the CLI listens (before the first
    poll) and asks for an image at each of the two iterations."""
    scene = str(tmp_path / "scene")
    write_colmap_scene(bench_scene(60, RES, RES, 1, seed=4), scene)
    replies, errors, threads = [], [], []
    init = network_gui.init

    def init_and_connect(host, port):
        init(host, port)
        threads.append(threading.Thread(target=_viewer, args=(
            connect(network_gui.listener), [(RES, 0), (RES, 0)], replies, errors), daemon=True))
        threads[0].start()

    monkeypatch.setattr(network_gui, "init", init_and_connect)
    state = t_train.main(["-s", scene, "-m", str(tmp_path / "model"), "--device", "cpu",
                          "--gui", "--port", "0", "--sh_degree", "0", "--gaussian_capacity",
                          "128", "--tile", "16", "--iterations", "2", "--test_iterations",
                          "-1", "--save_iterations", "2", "--checkpoint_iterations", "-1",
                          "--quiet"])
    threads[0].join(TIMEOUT)
    assert not threads[0].is_alive() and not errors, errors
    assert state.step == 2 and len(replies) == 2
    for image, src in replies:
        assert len(image) == RES * RES * 3 and src == os.path.abspath(scene)
