"""raster_fwd_roofline: the compositing forward's share of its roofline:
the larger of its operations over the FP32 peak and its bytes over the HBM
peak (``benchlib/counts.py``), for the blended pairs the benchmark counts,
over ``raster_fwd_kernel``'s profiled time."""
from benchlib import roofline


def read(rec, peak):
    return roofline.share(rec, peak, "raster_fwd_kernel", "raster_fwd")
