"""What the tests of the port's exact-skip binning share.

The port bins each Gaussian over the tiles that hold a pixel within its
exact-skip radius, inside the reference's 3-sigma rect, so that it
composites exactly the pairs of the 3-sigma rect.  The JAX package shrinks
the rect with ``getRect``'s formula at that fractional radius, which leaves
out tile k whenever p + r falls in [k tile, k tile + 1), and with it pairs
that blend.  So the port's renders and gradients are held to the JAX
package's 3-sigma binning (``jax_3sigma_binning``), and its instance lists
to the pairs that the kernels' alpha test accepts (``candidate``)."""
import contextlib

import jax
import numpy as np
import torch

ALPHA_MIN_F32 = np.float32(1.0) / np.float32(255.0)


@contextlib.contextmanager
def jax_3sigma_binning():
    """The JAX package's rasterizer binning over the 3-sigma tile rect
    (its ``preprocess`` without ``opacity``) for the duration of the block.
    JAX's caches are cleared on the way in and out, so that nothing traced
    with the other binning is reused."""
    from gaussianhaircut_tpu.ops.rasterize import common as JC
    real = JC.preprocess
    JC.preprocess = lambda *a, opacity=None, **k: real(*a, **k)
    jax.clear_caches()
    try:
        yield
    finally:
        JC.preprocess = real
        jax.clear_caches()


def candidate(mean_pix, conic, opacity, px, py) -> torch.Tensor:
    """The kernels' float32 test of the pairs (Gaussian, pixel): power <= 0
    and min(0.99, op exp(power)) >= 1/255.  mean_pix [..., 2], conic
    [..., 3] and opacity [...] broadcast against the pixel coordinates px,
    py."""
    dx = mean_pix[..., 0] - px
    dy = mean_pix[..., 1] - py
    a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(opacity * torch.exp(power), max=0.99)
    return (power <= 0.0) & (alpha >= float(ALPHA_MIN_F32))
