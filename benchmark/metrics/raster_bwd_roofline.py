"""raster_bwd_roofline: the compositing backward's share of its roofline:
the larger of its operations over the FP32 peak and its bytes over the HBM
peak (``benchlib/counts.py``), for the blended pairs the benchmark counts,
over ``raster_bwd_kernel``'s profiled time."""
from benchlib import roofline


def read(rec, peak):
    return roofline.share(rec, peak, "raster_bwd_kernel", "raster_bwd")
