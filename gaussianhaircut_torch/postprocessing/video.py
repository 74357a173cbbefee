"""Visualization / video postprocessing (port of ``gaussianhaircut_tpu/
postprocessing/video.py``; role-equivalents of src/postprocessing/
render_video.py, render_color.py, concat_video.py):

- ``interpolate_camera_path``: a rotation spline and a lerp of translations
  through key cameras (render_video.py's interpolation of K/R/T);
- ``write_video``: a directory of PNG frames -> one video file;
- ``concat_videos``: side-by-side GT | render panels (concat_video.py:22,41);
- ``export_blender_inputs`` and ``blender_render``: the Blender hand-off, the
  camera matrices and paths that ``blender_render_script.py`` (run inside
  Blender) reads.

The JAX package encodes MPEG-4 (``mp4v``) through OpenCV.  The GPU machine
has no video encoder, so the port writes an AVI container (RIFF with an
``idx1`` index) whose frames are PNG files, fourcc ``MPNG``: lossless, read by
FFmpeg (and so by OpenCV's FFMPEG backend); ``read_avi`` reads it back.
"""
from __future__ import annotations

import os
import pickle
import struct

import numpy as np
import torch
import torch.nn.functional as F

from gaussianhaircut_torch.preprocessing.frames import imread_rgb
from gaussianhaircut_torch.utils.image import encode_png, png_header

FOURCC = b"MPNG"
_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def interpolate_camera_path(rotations: np.ndarray, translations: np.ndarray,
                            key_times, sample_times) -> tuple[np.ndarray, np.ndarray]:
    """RotationSpline over key rotations + lerp of translations."""
    from scipy.spatial.transform import Rotation, RotationSpline
    spline = RotationSpline(key_times, Rotation.from_matrix(rotations))
    r = spline(sample_times).as_matrix()
    t = np.stack([np.interp(sample_times, key_times, translations[:, i])
                  for i in range(translations.shape[1])], axis=-1)
    return r, t


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def write_avi(out_path: str, frames: list, width: int, height: int, fps: int) -> None:
    """PNG byte strings of ``width`` x ``height`` RGB frames -> an AVI
    file (one video stream, fourcc MPNG, every frame a key frame)."""
    n = len(frames)
    biggest = max(len(f) for f in frames)
    avih = struct.pack("<14I", round(1e6 / fps), biggest * fps, 0, _AVIF_HASINDEX, n, 0, 1,
                       biggest, width, height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", FOURCC, 0, 0, 0, 0, 1, fps, 0, n,
                       biggest, -1, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, FOURCC,
                       width * height * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi, index, offset = [], [], 4            # offsets count from the 'movi' tag
    for f in frames:
        movi.append(_chunk(b"00dc", f))
        index.append(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME, offset, len(f)))
        offset += len(movi[-1])
    body = (b"AVI " + hdrl + _list(b"movi", b"".join(movi))
            + _chunk(b"idx1", b"".join(index)))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def read_avi(path: str) -> dict:
    """An AVI that ``write_avi`` wrote -> {"width", "height", "fps",
    "fourcc", "frames": the frames' bytes in the order of the index}."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")
    chunks, pos = {}, 12
    while pos + 8 <= len(data):
        tag, size = struct.unpack("<4sI", data[pos:pos + 8])
        kind = data[pos + 8:pos + 12] if tag == b"LIST" else tag
        chunks[kind] = pos
        pos += 8 + size + (size & 1)
    hdrl, movi, idx1 = (chunks.get(k) for k in (b"hdrl", b"movi", b"idx1"))
    if None in (hdrl, movi, idx1):
        raise ValueError(f"{path}: no hdrl, movi or idx1")
    width, height = struct.unpack("<II", data[hdrl + 12 + 8 + 32:hdrl + 12 + 8 + 40])
    strh = data.index(b"strh", hdrl) + 8
    fourcc = data[strh + 4:strh + 8]
    scale, rate = struct.unpack("<II", data[strh + 20:strh + 28])
    size = struct.unpack("<I", data[idx1 + 4:idx1 + 8])[0]
    frames, base = [], movi + 8
    for e in range(idx1 + 8, idx1 + 8 + size, 16):
        _, _, off, length = struct.unpack("<4sIII", data[e:e + 16])
        frames.append(data[base + off + 8:base + off + 8 + length])
    return {"width": width, "height": height, "fps": rate / scale, "fourcc": fourcc,
            "frames": frames}


def _png_rgb(path: str) -> tuple[bytes, int, int]:
    """A frame file as the bytes of an 8-bit RGB PNG (the file itself when
    it is one, else decoded as OpenCV's ``imread`` decodes it and encoded
    again) and its size."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: frames are read as PNG only")
    w, h, ch = png_header(path)
    if ch == 3:
        with open(path, "rb") as f:
            return f.read(), w, h
    return encode_png(imread_rgb(path)), w, h


def write_video(frames_dir: str, out_path: str, fps: int = 30) -> None:
    """The ``.png`` / ``.jpg`` frames of ``frames_dir`` in name order -> an
    AVI at ``out_path`` (JPEG frames raise: no decoder)."""
    names = sorted(n for n in os.listdir(frames_dir)
                   if n.endswith((".png", ".jpg")))
    if not names:
        raise FileNotFoundError(f"no frames in {frames_dir}")
    frames = [_png_rgb(os.path.join(frames_dir, n)) for n in names]
    w, h = frames[0][1:]
    bad = [n for n, f in zip(names, frames) if f[1:] != (w, h)]
    if bad:
        raise ValueError(f"{frames_dir}: frames {bad[:3]} are not {w}x{h}")
    write_avi(out_path, [f[0] for f in frames], w, h, fps)


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` (INTER_LINEAR, half-pixel
    centres, edges replicated) of uint8 [H, W, C], in float: within one
    level of OpenCV's 11-bit fixed point."""
    if img.shape[:2] == (height, width):
        return img.copy()
    x = torch.as_tensor(img, dtype=torch.float32).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def concat_videos(dirs: list[str], out_path: str, fps: int = 30) -> None:
    """Side-by-side panel video from several frame directories
    (concat_video.py's GT | blender | 3DGS layout): each panel scaled to the
    smallest first-frame height."""
    name_lists = [sorted(os.listdir(d)) for d in dirs]
    n = min(len(names) for names in name_lists)
    first = [imread_rgb(os.path.join(d, names[0])) for d, names in zip(dirs, name_lists)]
    h = min(f.shape[0] for f in first)
    widths = [int(f.shape[1] * h / f.shape[0]) for f in first]
    frames = []
    for i in range(n):
        row = [resize_linear(imread_rgb(os.path.join(d, names[i])), w, h)
               for d, names, w in zip(dirs, name_lists, widths)]
        frames.append(encode_png(np.concatenate(row, axis=1)))
    write_avi(out_path, frames, sum(widths), h, fps)


def export_blender_inputs(out_dir: str, camera_params: dict,
                          strands_pkl: str, head_ply: str) -> None:
    """Write the blender hand-off bundle render_color.py expects: camera
    projection pkl + paths file."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cameras.pkl"), "wb") as f:
        pickle.dump(camera_params, f)
    with open(os.path.join(out_dir, "inputs.txt"), "w") as f:
        f.write(f"strands={os.path.abspath(strands_pkl)}\n")
        f.write(f"head={os.path.abspath(head_ply)}\n")


def blender_render(blender_binary: str, inputs_dir: str, out_dir: str) -> None:
    """Shell out to Blender with the bundled Cycles script (render_video.py:
    207-214's process boundary); raises if no binary."""
    import shutil
    import subprocess
    if not shutil.which(blender_binary):
        raise FileNotFoundError(
            f"Blender binary '{blender_binary}' not found; run "
            "postprocessing on a machine with Blender 3.6 using "
            "blender_render_script.py")
    script = os.path.join(os.path.dirname(__file__), "blender_render_script.py")
    subprocess.check_call([blender_binary, "-b", "-P", script, "--",
                           inputs_dir, out_dir])
