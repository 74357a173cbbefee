"""Scene loading: COLMAP / Blender-JSON / Synthetic(cameras.npz) readers with
per-view GT (images, hair/body masks, Gabor orientation maps).  A copy of
``gaussianhaircut_tpu/scene/dataset.py`` that reads PNGs with the port's own
codec (``utils/image.py``) and resizes 8-bit images in numpy with PIL's
own integer arithmetic, since PIL is not a dependency of the port.  Images
must therefore be 8-bit PNGs, as the pipeline writes them (the GT paths
already assume ``.png``: the variance file is the image path with ``png``
replaced by ``npy``).

Behavioral model: src/scene/dataset_readers.py + src/utils/camera_utils.py.
Kept host-side (numpy); the trainer stacks what it needs into device
arrays.  Differences from the reference are deliberate simplifications of
mechanism, not behavior:
- camera spline interpolation uses scipy RotationSpline + lerp exactly like
  dataset_readers.py:160-193;
- GT loading mirrors camera_utils.py:51-78 (orientation PNG in degrees/180,
  variance .npy -> confidence 1/(var^2+1e-7), body-mask background
  compositing, eval split ``idx % 2`` when --eval).
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from gaussianhaircut_torch.config import ModelConfig
from gaussianhaircut_torch.scene import colmap, ply
from gaussianhaircut_torch.scene.cameras import CameraStatic, world_to_view
from gaussianhaircut_torch.utils.image import png_size, read_png


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


@dataclass
class SceneData:
    train_cameras: list
    test_cameras: list
    points: np.ndarray
    colors: np.ndarray
    cameras_extent: float
    ply_path: str = ""
    translate: np.ndarray = field(default_factory=lambda: np.zeros(3))


def nerfpp_norm(transforms: list[np.ndarray]) -> tuple[np.ndarray, float]:
    """Scene center/radius from camera centers (dataset_readers.py:54-75)."""
    centers = np.stack([np.linalg.inv(t)[:3, 3] for t in transforms])
    center = centers.mean(0)
    radius = float(np.linalg.norm(centers - center, axis=-1).max()) * 1.1
    return -center, radius


_PRECISION_BITS = 22      # fixed-point fraction bits of PIL's 8-bit resample


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic kernel, a = -0.5, in its own order of operations."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: np.ndarray) -> np.ndarray:
    """PIL's Lanczos kernel (a sinc windowed by sinc(x / 3) on [-3, 3)),
    element by element through libm's ``sin``, as PIL's C code calls it,
    so that no coefficient rounds differently."""
    flat = [_sinc(v) * _sinc(v / 3) if -3.0 <= v < 3.0 else 0.0
            for v in np.asarray(x, np.float64).ravel().tolist()]
    return np.asarray(flat, np.float64).reshape(np.shape(x))


# PIL's resampling filters: (kernel, support)
_FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


def _resample_coeffs(in_size: int, out_size: int, resample: str = "bicubic"):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bicubic (support 2) or Lanczos (support 3) filter, the support widened by
    the scale when shrinking: per output index the first input index and the
    integer coefficients [out_size, ksize] with 22 fraction bits (zero past
    each window)."""
    kernel, base_support = _FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # float -> int casts truncate toward zero, as in C
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)[None, :]
    inside = x < xmax[:, None]
    k = np.where(inside, kernel(((x + xmin[:, None]) - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):                  # PIL's order of summation
        ww = ww + k[:, i]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    k = k * (1 << _PRECISION_BITS)
    kk = np.where(k < 0, np.trunc(-0.5 + k), np.trunc(0.5 + k)).astype(np.int64)
    return xmin, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   resample: str = "bicubic", device="cpu") -> np.ndarray:
    """One pass of PIL's 8-bit resample along ``axis`` of [H, W, C] uint8:
    integer sums of the fixed-point coefficients over each output's window
    of taps, in int64 on ``device``, rounded and clipped."""
    xmin, kk = _resample_coeffs(img.shape[axis], out_size, resample)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :],
                     img.shape[axis] - 1)                    # [out, ksize]
    src = torch.as_tensor(np.moveaxis(img, axis, 0).copy(), device=device).to(torch.int64)
    idx = torch.as_tensor(idx, device=device)
    kk = torch.as_tensor(kk, device=device).reshape(kk.shape + (1,) * (src.ndim - 1))
    ss = torch.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                    dtype=torch.int64, device=device)
    for i in range(kk.shape[1]):
        ss += src[idx[:, i]] * kk[:, i]
    out = torch.where(ss <= 0, 0, torch.where(ss >= (1 << _PRECISION_BITS << 8), 255,
                                              ss >> _PRECISION_BITS))
    return np.moveaxis(out.to(torch.uint8).cpu().numpy(), 0, axis)


def _resize_uint8(img: np.ndarray, resolution: tuple[int, int],
                  resample: str = "bicubic", device="cpu") -> np.ndarray:
    """PIL's ``Image.resize(resolution, resample)`` of an 8-bit image
    [H, W(, C)] for ``resample`` "bicubic" (PIL's default) or "lanczos", in
    PIL's integer arithmetic: a copy when the size is unchanged, else its
    resample (widened when shrinking), the horizontal pass and then the
    vertical, each only where that size changes and each rounded and
    clipped to 8 bits.  Gray + alpha and RGBA are resized premultiplied
    (``La`` / ``RGBa``: round(c * a / 255)) and divided back with PIL's
    flooring division (c * 255 // a where 0 < a < 255).  The passes' sums
    run on the torch ``device``."""
    w, h = resolution
    if img.shape[1] == w and img.shape[0] == h:
        return img.copy()
    x = img.reshape(img.shape[0], img.shape[1], -1)
    alpha = x.shape[2] in (2, 4)
    if alpha:
        x = x.astype(np.int64)
        t = x[..., :-1] * x[..., -1:] + 128
        x = np.concatenate([((t >> 8) + t) >> 8, x[..., -1:]], -1).astype(np.uint8)
    if x.shape[1] != w:
        x = _resample_axis(x, w, 1, resample, device)
    if x.shape[0] != h:
        x = _resample_axis(x, h, 0, resample, device)
    if alpha:
        a = x[..., -1:].astype(np.int64)
        c = x[..., :-1].astype(np.int64)
        div = np.minimum(255 * c // np.maximum(a, 1), 255)
        x = np.concatenate([np.where((a > 0) & (a < 255), div, c), a], -1).astype(np.uint8)
    return x[..., 0] if img.ndim == 2 else x


def _load_image(path: str, resolution: tuple[int, int], max_value: float = 255.0) -> np.ndarray:
    """PNG load + 8-bit resize -> [C, H, W] float (general_utils.py:22-28).
    The resize comes before the division, as in PIL."""
    arr = _resize_uint8(read_png(path), resolution).astype(np.float32) / max_value
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr.transpose(2, 0, 1)


def _resize_map(arr: np.ndarray, resolution: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a [H, W] float array (camera_utils.py:67), as
    PIL's mode "F" BILINEAR (widened when shrinking; torch's
    ``antialias=True``).  Leading singleton axes are squeezed:
    render_gaussians exports orient_confs as [1, H, W]."""
    arr = np.asarray(arr, np.float32)
    while arr.ndim > 2 and arr.shape[0] == 1:
        arr = arr[0]
    w, h = resolution
    if arr.shape == (h, w):
        return arr.copy()
    y = torch.nn.functional.interpolate(
        torch.from_numpy(np.ascontiguousarray(arr))[None, None], size=(h, w),
        mode="bilinear", align_corners=False, antialias=True)
    return y[0, 0].numpy()


def _pick_resolution(orig_w: int, orig_h: int, resolution: int,
                     resolution_scale: float = 1.0) -> tuple[int, int]:
    """camera_utils.py:32-49."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_view_gt(image_path: str, images_dir_name: str, resolution,
                 cfg: ModelConfig):
    """GT maps for one view (camera_utils.py:51-78).  Returns dict of
    [C, H, W] arrays."""
    if cfg.load_synthetic_rgba:
        base = os.path.basename(image_path).split(".")[0]
        root = f"{cfg.model_path}/train_cropped/ours_{cfg.iteration_data}"
        image = _load_image(f"{root}/renders/{base}.png", resolution)[:3]
        mask_body = _load_image(f"{root}/head_masks/{base}.png", resolution)[:1]
        mask_hair = _load_image(f"{root}/hair_masks/{base}.png", resolution)[:1]
    else:
        image = _load_image(image_path, resolution)[:3]
        mask_body = _load_image(
            image_path.replace(images_dir_name, f"masks_2/body"), resolution)[:1]
        mask_hair = _load_image(
            image_path.replace(images_dir_name, f"masks_2/hair"), resolution)[:1]

    if cfg.load_synthetic_geom:
        base = os.path.basename(image_path).split(".")[0]
        root = f"{cfg.model_path}/train_cropped/ours_{cfg.iteration_data}"
        orient_angle = _load_image(f"{root}/orients/{base}.png", resolution)[:1]
        conf = np.load(f"{root}/orient_confs/{base}.npy").astype(np.float32)
        orient_conf = _resize_map(conf, resolution)[None]
    else:
        orient_angle = _load_image(
            image_path.replace(images_dir_name, "orientations_2/angles"),
            resolution, max_value=180.0)[:1]
        var = np.load(image_path.replace(images_dir_name, "orientations_2/vars")
                      .replace("png", "npy")).astype(np.float32) / math.pi ** 2
        var = _resize_map(var, resolution)
        orient_conf = (1.0 / (var ** 2 + 1e-7))[None]

    if cfg.binarize_masks:
        mask_body = (mask_body >= 0.5).astype(np.float32)
        mask_hair = (mask_hair >= 0.5).astype(np.float32)
    # composite over white/black background by the body mask (cameras.py:64)
    white = float(cfg.white_background)
    image = np.clip(image, 0, 1) * mask_body + white * (1 - mask_body)
    return dict(image=image, mask_body=np.clip(mask_body, 0, 1),
                mask_hair=np.clip(mask_hair, 0, 1),
                orient_angle=np.clip(orient_angle, 0, 1),
                orient_conf=orient_conf)


def _make_camera(uid, colmap_id, name, R, T, fovx, fovy, image_path,
                 images_dir_name, cfg: ModelConfig, load_gt=True) -> CameraStatic:
    w2c = world_to_view(R, T)
    cam = CameraStatic(uid=uid, colmap_id=colmap_id, image_name=name,
                       width=0, height=0, colmap_transform=w2c,
                       fovx=float(fovx), fovy=float(fovy))
    if image_path and os.path.exists(image_path):
        orig_w, orig_h = png_size(image_path)
        resolution = _pick_resolution(orig_w, orig_h, cfg.resolution)
        cam.width, cam.height = resolution
        if load_gt:
            gt = load_view_gt(image_path, cfg.images, resolution, cfg)
            cam.image = gt["image"]
            cam.mask_body = gt["mask_body"]
            cam.mask_hair = gt["mask_hair"]
            cam.orient_angle = gt["orient_angle"]
            cam.orient_conf = gt["orient_conf"]
            cam.width = cam.image.shape[2]
            cam.height = cam.image.shape[1]
    return cam


def _interpolate_cameras(entries, speed_up, max_frames, frame_offset):
    """Rotation-spline + lerp interpolation over frame indices
    (dataset_readers.py:160-193).  entries: list of dicts with R, T, fovx,
    fovy, name(int frame), image_path."""
    from scipy.spatial.transform import Rotation, RotationSpline
    frames = [int(e["name"]) for e in entries]
    spline = RotationSpline(frames, Rotation.from_matrix(
        np.stack([e["R"] for e in entries])))
    r_interp = spline(list(range(frames[-1]))).as_matrix()

    out = []
    prev_j, next_j = -1, 0
    for i in range(frames[-1]):
        if i in frames:
            prev_j += 1
            next_j += 1
        a = 1 - (i - frames[prev_j]) / (frames[next_j] - frames[prev_j])
        e0, e1 = entries[prev_j], entries[next_j]
        out.append(dict(
            R=r_interp[i],
            T=e0["T"] * a + e1["T"] * (1 - a),
            fovx=e0["fovx"] * a + e1["fovx"] * (1 - a),
            fovy=e0["fovy"] * a + e1["fovy"] * (1 - a),
            name="%06d" % i,
            image_path=e0["image_path"].replace("%06d" % prev_j, "%06d" % i),
            colmap_id=e0["colmap_id"],
        ))
    return out[frames[0]:frames[-1]][::speed_up][frame_offset:frame_offset + max_frames]


def load_colmap_scene(cfg: ModelConfig, load_gt: bool = True,
                      llffhold: int = 2) -> SceneData:
    """dataset_readers.py:144-224."""
    sparse = os.path.join(cfg.source_path, "sparse/0")
    cams, imgs, pts = colmap.read_model(sparse)

    entries = []
    for img in imgs.values():
        intr = cams[img.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[0], intr.height)
        elif intr.model == "PINHOLE":
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[1], intr.height)
        else:
            raise ValueError(f"unsupported COLMAP camera model {intr.model}")
        image_path = os.path.join(cfg.source_path, cfg.images or "images",
                                  os.path.basename(img.name))
        if load_gt and not os.path.exists(image_path):
            continue
        entries.append(dict(
            R=colmap.qvec_to_rotmat(img.qvec).T, T=np.array(img.tvec),
            fovx=fovx, fovy=fovy,
            name=os.path.basename(image_path).split(".")[0],
            image_path=image_path, colmap_id=intr.id))
    entries.sort(key=lambda e: e["name"])

    if cfg.interpolate_cameras:
        entries = _interpolate_cameras(entries, cfg.speed_up, cfg.max_frames,
                                       cfg.frame_offset)

    cameras = [
        _make_camera(i, e["colmap_id"], e["name"], e["R"], e["T"], e["fovx"],
                     e["fovy"], e["image_path"], cfg.images, cfg, load_gt)
        for i, e in enumerate(entries)
    ]

    if cfg.eval:
        train = [c for i, c in enumerate(cameras) if i % llffhold != 0]
        test = [c for i, c in enumerate(cameras) if i % llffhold == 0]
    else:
        train, test = cameras, []

    translate, radius = nerfpp_norm([c.colmap_transform for c in train])

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path) and pts is not None:
        xyz, rgb, _ = pts
        ply.store_point_cloud(ply_path, xyz, rgb.astype(np.float64))
    points, colors, _ = ply.fetch_point_cloud(ply_path)
    return SceneData(train, test, points, colors, radius, ply_path, translate)


def load_blender_scene(cfg: ModelConfig, load_gt: bool = True) -> SceneData:
    """transforms_train/test.json reader (dataset_readers.py:226-303)."""
    def read(split):
        with open(os.path.join(cfg.source_path, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        out = []
        for i, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1      # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            R, T = w2c[:3, :3].T, w2c[:3, 3]
            path = os.path.join(cfg.source_path, frame["file_path"] + ".png")
            w, h = png_size(path)
            fovy = focal2fov(fov2focal(fovx, w), h)
            cam = CameraStatic(uid=i, colmap_id=i, image_name=os.path.basename(path).split(".")[0],
                               width=w, height=h,
                               colmap_transform=world_to_view(R, T),
                               fovx=fovx, fovy=fovy)
            if load_gt:
                rgba = _to_rgba(read_png(path)).astype(np.float32) / 255.0
                bgv = 1.0 if cfg.white_background else 0.0
                rgb = rgba[..., :3] * rgba[..., 3:] + bgv * (1 - rgba[..., 3:])
                cam.image = rgb.transpose(2, 0, 1)
                cam.mask_body = rgba[..., 3:].transpose(2, 0, 1)
                cam.mask_hair = np.zeros_like(cam.mask_body)
                cam.orient_angle = np.zeros_like(cam.mask_body)
                cam.orient_conf = np.ones_like(cam.mask_body)
                cam.width, cam.height = w, h
            out.append(cam)
        return out

    train = read("train")
    test = read("test")
    if not cfg.eval:
        train = train + test
        test = []
    translate, radius = nerfpp_norm([c.colmap_transform for c in train])
    ply_path = os.path.join(cfg.source_path, "points3d.ply")
    if os.path.exists(ply_path):
        points, colors, _ = ply.fetch_point_cloud(ply_path)
    else:
        rng = np.random.default_rng(0)
        points = rng.random((100_000, 3)) * 2.6 - 1.3
        colors = rng.random((100_000, 3)) / 255.0 * 0.28209479177387814 + 0.5
        ply.store_point_cloud(ply_path, points, colors * 255)
    return SceneData(train, test, points, colors, radius, ply_path, translate)


def _to_rgba(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGBA")`` of an 8-bit gray, gray + alpha, RGB or RGBA
    image: gray is replicated, a missing alpha is 255."""
    if img.ndim == 2:
        img = img[..., None]
    ch = img.shape[-1]
    rgb = np.repeat(img[..., :1], 3, -1) if ch in (1, 2) else img[..., :3]
    alpha = img[..., -1:] if ch in (2, 4) else np.full_like(img[..., :1], 255)
    return np.concatenate([rgb, alpha], -1)


def load_synthetic_scene(cfg: ModelConfig, load_gt: bool = True,
                         llffhold: int = 2, resolution: int = 1024) -> SceneData:
    """cameras.npz reader (dataset_readers.py:306-389)."""
    path = cfg.source_path
    if os.path.exists(f"{path}/projection.npy"):
        mats = np.load(f"{path}/projection.npy")
    else:
        mats = np.load(f"{path}/cameras.npz")["arr_0"]

    cameras = []
    for i, world_mat in enumerate(mats):
        K, R, t = _krt_from_projection(world_mat[:3, :4])
        K = K / 2.0  # half-res intrinsics (dataset_readers.py:330-335,348)
        K[2, 2] = 1.0
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = t
        fovx = 2 * math.atan(resolution / 2 / K[0, 0])
        fovy = 2 * math.atan(resolution / 2 / K[1, 1])
        name = "%04d" % i
        image_path = os.path.join(path, cfg.images or "images", f"{name}.png")
        cam = _make_camera(0, i, name, R.T, t, fovx, fovy, image_path,
                           cfg.images, cfg, load_gt)
        cam.width = cam.width or resolution
        cam.height = cam.height or resolution
        cameras.append(cam)

    if cfg.eval:
        train = [c for i, c in enumerate(cameras) if i % llffhold != 0]
        test = [c for i, c in enumerate(cameras) if i % llffhold == 0]
    else:
        train, test = cameras, []
    translate, radius = nerfpp_norm([c.colmap_transform for c in train])
    rng = np.random.default_rng(0)
    points = rng.random((100_000, 3)) * 2.6 - 1.3
    colors = rng.random((100_000, 3)) / 255.0 * 0.28209479177387814 + 0.5
    return SceneData(train, test, points, colors, radius, "", translate)


def _krt_from_projection(P: np.ndarray):
    """Decompose P = K [R | t] (K upper-triangular, positive diagonal).
    Same math as NeuS's load_K_Rt_from_P but via scipy RQ."""
    import scipy.linalg
    K, R = scipy.linalg.rq(P[:3, :3])
    signs = np.sign(np.diag(K))
    K = K * signs[None, :]
    R = R * signs[:, None]
    if np.linalg.det(R) < 0:
        R = -R
    t = np.linalg.solve(K, P[:3, 3])
    K = K / K[2, 2]
    return K, R, t


def load_scene(cfg: ModelConfig, load_gt: bool = True) -> SceneData:
    """Scene-type sniffing like scene/__init__.py:45-53."""
    if os.path.exists(os.path.join(cfg.source_path, "sparse")):
        return load_colmap_scene(cfg, load_gt)
    if os.path.exists(os.path.join(cfg.source_path, "transforms_train.json")):
        return load_blender_scene(cfg, load_gt)
    if (os.path.exists(os.path.join(cfg.source_path, "projection.npy"))
            or os.path.exists(os.path.join(cfg.source_path, "cameras.npz"))):
        return load_synthetic_scene(cfg, load_gt)
    raise ValueError(f"could not recognize scene type at {cfg.source_path}")
