"""Image helpers: an 8-bit PNG reader and writer on ``zlib``, ``struct`` and
numpy, PNG save of float maps, and the orientation / depth visualisations
(a copy of ``gaussianhaircut_tpu/utils/image.py``; reference
image_utils.py:22-42).

The PNG codec covers what the pipeline reads and writes: 8-bit gray, gray +
alpha, RGB and RGBA, non-interlaced.  The reader undoes all five row filters
and returns the array PIL's ``np.asarray(Image.open(path))`` gives: [H, W]
for gray, [H, W, C] otherwise.  The writer stores every row unfiltered, or,
with ``like_pil``, writes the bytes PIL's ``Image.save`` writes: each row
takes the filter of least summed |signed byte| among None, Up, Sub and
Paeth (in that order, the first on ties; never Average), deflated at level 6
with memLevel 9 and the Z_FILTERED strategy, in IDAT chunks of 65536 bytes.
That costs about what PIL costs, and Paeth rows make ``read_png`` slow on a
large image, so only files that must equal the JAX package's byte for byte
(the scalp's ``dif_mask.png``) are written so.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # PNG colour type -> channels
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(path: str):
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _header(path: str, ihdr: bytes):
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or ctype not in _CHANNELS:
        raise NotImplementedError(
            f"{path}: PNG bit depth {depth}, colour type {ctype}; only 8-bit "
            "gray, gray + alpha, RGB and RGBA are read")
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG")
    return w, h, _CHANNELS[ctype]


def png_header(path: str) -> tuple[int, int, int]:
    """(width, height, channels) from the header."""
    kind, ihdr = next(_chunks(path))
    if kind != b"IHDR":
        raise ValueError(f"{path}: PNG does not start with IHDR")
    return _header(path, ihdr)


def png_size(path: str) -> tuple[int, int]:
    """(width, height) from the header, as PIL's ``Image.open(p).size``."""
    return png_header(path)[:2]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` [h, 1 + w * bpp] -> [h, w, bpp].

    Rows filtered with None, Sub or Up only are undone row by row.  Average
    and Paeth make a pixel depend on the one left of it, so with either
    present the pixels are reconstructed by anti-diagonals (x + y = d): all
    of a diagonal's inputs (left, up, up-left) lie on the two before it."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    filt = raw[:, 1:].reshape(h, w, bpp)
    if not np.isin(ftype, (3, 4)).any():
        out = np.empty((h, w, bpp), np.uint8)
        prev = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            row = filt[y]
            if ftype[y] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif ftype[y] == 2:
                row = row + prev
            out[y] = prev = row
        return out
    # padded: out[y + 1, x + 1] is pixel (y, x); row 0 and column 0 are zero
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    vals = filt.astype(np.int32)
    ft = ftype.astype(np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = out[ys + 1, xs]          # left
        b = out[ys, xs + 1]          # up
        c = out[ys, xs]              # up-left
        f = ft[ys][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        out[ys + 1, xs + 1] = (vals[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """8-bit PNG -> uint8 [H, W] (gray) or [H, W, C] (gray + alpha, RGB,
    RGBA)."""
    header, idat = None, []
    for kind, body in _chunks(path):
        if kind == b"IHDR":
            header = _header(path, body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, ch = header
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected "
                         f"{h * (1 + w * ch)}")
    img = _unfilter(raw.reshape(h, 1 + w * ch), h, w, ch)
    return img[..., 0] if ch == 1 else img


def _filter_rows(x: np.ndarray, bpp: int) -> np.ndarray:
    """[h, n] uint8 rows -> [h, 1 + n] filtered rows, each with the filter
    PIL's encoder picks (least summed |signed byte|; None, Up, Sub, Paeth
    in that order, the first on ties).  Differences wrap in uint8."""
    h = x.shape[0]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    # Paeth: the neighbour nearest to left + up - upleft
    a, b, c = (v.astype(np.int16) for v in (left, up, upleft))
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    cands = np.stack([x, x - up, x - left, x - pred])
    cost = np.minimum(cands, 0 - cands).sum(axis=2, dtype=np.int64)
    best = np.argmin(cost, axis=0)
    ftype = np.array([0, 2, 1, 4], np.uint8)[best]
    return np.concatenate([ftype[:, None], cands[best, np.arange(h)]], axis=1)


def write_png(path: str, img: np.ndarray, like_pil: bool = False) -> None:
    """uint8 [H, W] or [H, W, C] (C = 1, 2, 3, 4) -> 8-bit PNG, rows
    unfiltered; with ``like_pil``, byte for byte what PIL's
    ``Image.fromarray(img).save(path)`` writes."""
    data = encode_png(img, like_pil)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(img: np.ndarray, like_pil: bool = False) -> bytes:
    """The bytes ``write_png`` writes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png: expected uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _COLOR_TYPE:
        raise ValueError(f"write_png: {ch} channels")
    pixels = np.ascontiguousarray(img).reshape(h, w * ch)
    if like_pil:
        z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
        data = z.compress(_filter_rows(pixels, ch).tobytes()) + z.flush()
        idat = [data[i:i + 65536] for i in range(0, len(data), 65536)]
    else:
        rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels], axis=1)
        idat = [zlib.compress(rows.tobytes(), 6)]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + b"".join(chunk(b"IDAT", part) for part in idat) + chunk(b"IEND", b""))


def save_image(arr, path: str) -> None:
    """[C, H, W] or [H, W] float in [0,1] -> 8-bit PNG."""
    arr = np.asarray(arr)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
    write_png(path, (np.clip(arr, 0, 1) * 255).round().astype(np.uint8))


def vis_orient(orient_angle, mask):
    """Orientation color wheel (red=vertical, green=horizontal,
    magenta/teal=diagonals), angles in [0,1] ~ [0, pi)."""
    deg = np.asarray(orient_angle) * 180.0
    red = np.clip(1 - np.abs(deg - 0.0) / 45.0, 0, 1) + np.clip(1 - np.abs(deg - 180.0) / 45.0, 0, 1)
    green = np.clip(1 - np.abs(deg - 90.0) / 45.0, 0, 1)
    magenta = np.clip(1 - np.abs(deg - 45.0) / 45.0, 0, 1)
    teal = np.clip(1 - np.abs(deg - 135.0) / 45.0, 0, 1)
    r = red + magenta
    g = green + teal
    b = magenta + teal
    rgb = np.concatenate([r, g, b], axis=0)
    return np.clip(rgb, 0, 1) * np.asarray(mask)


def vis_depth(depth):
    d = np.log(np.asarray(depth) + 1)
    return (d - d.min()) / max(d.max() - d.min(), 1e-9)
