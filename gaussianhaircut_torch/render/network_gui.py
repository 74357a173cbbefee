"""Live-viewer socket server (the SIBR network_gui protocol, reference
src/gaussian_renderer/network_gui.py:26-85; a copy of
``gaussianhaircut_tpu/render/network_gui.py``).

Wire format (little-endian):
  receive: resolution (2x uint32), train flags (4 bytes), scaling modifier
           (f32), view/proj matrices (2x 16 f32), camera params json length +
           payload — exactly as the reference's receive() unpacks;
  send:    H*W*3 rendered bytes + source-path string.

The trainer (``train/stage1.poll_gui``) polls ``try_connect`` without
blocking each iteration and answers each received camera with a rendered
view.  ``init`` with port 0 listens on an ephemeral port
(``listener.getsockname()[1]``).
"""
from __future__ import annotations

import json
import socket
import struct
import traceback

import numpy as np

conn = None
addr = None
listener = None
host = "127.0.0.1"
port = 6009


def init(wish_host: str, wish_port: int) -> None:
    global host, port, listener
    host, port = wish_host, wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def try_connect() -> None:
    global conn, addr
    if listener is None:
        return
    try:
        conn, addr = listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except Exception:
        pass


def _read_bytes(n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = conn.recv(n - len(out))
        if not chunk:
            raise ConnectionError("viewer disconnected")
        out += chunk
    return out


def receive():
    """-> (custom_cam dict | None, do_training, convert_shs, compute_cov3d,
    keep_alive, scaling_modifier)."""
    message_length = struct.unpack("I", _read_bytes(4))[0]
    message = _read_bytes(message_length)
    width, height = struct.unpack("II", message[:8])
    do_training, convert_shs, compute_cov3d, keep_alive = struct.unpack(
        "bbbb", message[8:12])
    scaling_modifier = struct.unpack("f", message[12:16])[0]
    world_view = np.frombuffer(message[16:16 + 64], np.float32).reshape(4, 4)
    full_proj = np.frombuffer(message[80:80 + 64], np.float32).reshape(4, 4)
    extra_len = struct.unpack("I", message[144:148])[0]
    extra = json.loads(message[148:148 + extra_len].decode()) if extra_len else {}
    cam = None
    if width and height:
        cam = dict(width=int(width), height=int(height),
                   world_view_transform=world_view,
                   full_proj_transform=full_proj,
                   fovx=float(extra.get("fov_x", 1.0)),
                   fovy=float(extra.get("fov_y", 1.0)))
    return (cam, bool(do_training), bool(convert_shs), bool(compute_cov3d),
            bool(keep_alive), float(scaling_modifier))


def send(image_bytes, source_path: str) -> None:
    global conn
    try:
        if image_bytes is not None:
            conn.sendall(image_bytes)
        conn.sendall(len(source_path).to_bytes(4, "little"))
        conn.sendall(source_path.encode())
    except Exception:
        traceback.print_exc()
        conn = None
