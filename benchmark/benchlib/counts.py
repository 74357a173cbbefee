"""Operations and bytes the mathematics of a training step needs, counted
from shapes and from the benchmark's own count of the compositing's work
(``reference.render.count_work``), never from what a kernel visits.
FP32 operations; a multiply-add counts 2; exp, sqrt, division and
comparison count 1 each.

Compositing, per blended (pixel, Gaussian) pair, the blend of
``reference/raster.py``:

- forward, 40: dx, dy (2); power = -0.5 (a dx^2 + c dy^2) - b dx dy (9);
  exp (1); raw = opacity * exp (1); the 0.99 clamp (1); the power and 1/255
  tests (2); T (1 - alpha) (2); the 1e-4 test (1); w = alpha T (1); 10
  channels accumulated (20);
- backward, 90: the forward's first 20 again (20); the upstream gradient
  dotted with the colour, u (19); the running prefix (2) and the suffix (1);
  d alpha = u T - suffix / (1 - alpha) (4); d power = d alpha raw (1);
  d mean x, y (4 + 4); d conic a, b, c (3 + 2 + 3); d opacity (1); d colour,
  10 channels (10); the 16 per-pair terms summed over the tile's pixels (16).

Bytes of the compositing: each Gaussian with a blended pair reads its 16
inputs once (mean 2, conic 3, opacity 1, colour 10); the forward writes each
pixel's 10 channels and final T once; the backward reads each pixel's
upstream gradient (10 channels and T) and final T once and writes each such
Gaussian's 16 gradients once.  Four bytes each.

Per element, forward (the backward counted twice the forward):

- per Gaussian, the render precompute, 490: the quaternion to a rotation
  (48), the 3D covariance (63), the view transform (21), the EWA Jacobian
  and T = W J (68), the 2D covariance (60), the conic (8), the NDC mean (28),
  the view direction (12), SH degree 3 (136), the clamp (6), the 2D
  direction (23), the activations (15), the pixel mean (4);
- per strand segment, strand to Gaussian, 60: midpoint and vector (9), the
  parallel transport (24), the half length (7), scales (2), the per-segment
  copies of colour and confidence (18);
- per pixel, the stage-1 losses, 790: masked L1 on 3 channels (9), SSIM's
  five separable 11-tap blurs of 3 channels (660) and its map (60), mask L1
  (6), the orientation decode and loss (30), the background blend (20) -- the
  maths of an 11-tap window, whatever product computes it; stage 2 has no
  SSIM: 65;
- per parameter, Adam 16 (moments 7, the step 8, the NaN guard 1), AdamW
  18 (plus the decay), the global-norm clip 3, the EMA 3;
- networks: 2 per multiply-add of every dense and convolution product from
  its shapes; the GroupNorms and activations are left out.
"""
from __future__ import annotations

FWD_OPS_PER_PAIR = 40
BWD_OPS_PER_PAIR = 90
GAUSSIAN_INPUTS = 16
PIXEL_OUTPUTS = 11
PRECOMPUTE_OPS = 490
SEGMENT_OPS = 60
PIXEL_OPS = {"stage1": 790, "stage2": 65}
ADAM_OPS, ADAMW_OPS, CLIP_OPS, EMA_OPS = 16, 18, 3, 3
DENSIFY_STATS_OPS = 10


def raster_fwd(work: dict) -> tuple[float, float]:
    """(operations, bytes) of the compositing forward."""
    ops = work["pairs"] * FWD_OPS_PER_PAIR
    nbytes = 4 * (work["gaussians_blended"] * GAUSSIAN_INPUTS + work["pixels"] * PIXEL_OUTPUTS)
    return float(ops), float(nbytes)


def raster_bwd(work: dict) -> tuple[float, float]:
    """(operations, bytes) of the compositing backward."""
    ops = work["pairs"] * BWD_OPS_PER_PAIR
    nbytes = 4 * (2 * work["gaussians_blended"] * GAUSSIAN_INPUTS
                  + work["pixels"] * (PIXEL_OUTPUTS + 1))
    return float(ops), float(nbytes)


def bound_s(ops: float, nbytes: float, peak: dict) -> tuple[float, str]:
    """The least time the card could take and which peak bounds it."""
    t_ops, t_bytes = ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dense(rows: int, n_in: int, n_out: int) -> float:
    return 2.0 * rows * n_in * n_out


def conv(h: int, w: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * h * w * c_in * c_out * k * k


def strand_decoder(n: int, length: int, hidden: int = 256, freqs: int = 6,
                   latent: int = 64) -> float:
    seg = length - 1
    return (dense(n, latent, hidden) + dense(seg, 2 * freqs + 1, hidden)
            + 2 * dense(n * seg, hidden, hidden) + dense(n * seg, hidden, 3))


def colour_decoder(n: int, sh_degree: int, hidden: int = 128, latent: int = 64) -> float:
    return (dense(n, latent, hidden) + dense(n, hidden, hidden)
            + dense(n, hidden, 3 * (sh_degree + 1) ** 2 + 1))


def unet(cfg: dict) -> float:
    """One forward of the UNet at batch 1 (``reference.strands.unet``)."""
    size, m = cfg["input_size"], cfg["mapping_out"]
    total = dense(1, 16, m) + dense(1, m, m)
    c, res = cfg["input_channels"], size
    skips = []
    for level, (depth, ch) in enumerate(zip(cfg["depths"], cfg["channels"])):
        if level > 0:
            res //= 2
        for _ in range(depth):
            total += _block(res, c, ch, m)
            c = ch
        skips.append((res, ch))
    for level in reversed(range(len(cfg["depths"]))):
        res, ch = skips[level]
        if level < len(cfg["depths"]) - 1:
            c += ch
        for _ in range(cfg["depths"][level]):
            total += _block(res, c, ch, m)
            c = ch
    return total + conv(size, size, c, cfg["input_channels"], 3)


def _block(res: int, c_in: int, c_out: int, m: int) -> float:
    f = dense(1, m, 2 * c_out) + conv(res, res, c_in, c_out, 3) + conv(res, res, c_out, c_out, 3)
    return f + (conv(res, res, c_in, c_out, 1) if c_in != c_out else 0.0)
