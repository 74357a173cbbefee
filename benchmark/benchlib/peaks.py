"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit), by the name
``torch.cuda.get_device_name`` gives.  A card not listed has no peak, and
the shares of a peak are not reported on it."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def peak(device_name: str) -> dict | None:
    return PEAKS.get(device_name)
