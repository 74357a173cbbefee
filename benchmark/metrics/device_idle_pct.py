"""device_idle_pct: 100 x (1 - the union of the device's busy intervals over
the wall time of sub-window A), profiled with CUDA activity only."""


def read(rec, peak):
    a = rec.traced.get("a")
    if not a or a["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - a["busy_s"] / a["wall_s"])
