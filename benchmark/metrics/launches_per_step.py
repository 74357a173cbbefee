"""launches_per_step: device operations (kernels, memcpy and memset) per step
in sub-window A, profiled with CUDA activity only."""


def read(rec, peak):
    a = rec.traced.get("a")
    if not a or not a["events"]:
        return None
    return a["events"] / a["steps"]
