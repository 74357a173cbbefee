"""A kernel's share of its roofline, for the metric readers: the least time
the card could take for the work the benchmark counted on the roofline
steps' snapshots, over the kernel's profiled time in those steps, in
percent."""
from benchlib import counts


def share(rec, peak, kernel: str, work_key: str):
    d, work = rec.traced.get("d"), rec.traced.get("work")
    if not peak or not d or not work:
        return None
    t = sum(x["kernel_s"].get(kernel, 0.0) for x in d)
    if t <= 0:
        return None
    bound = sum(counts.bound_s(*w[work_key], peak)[0] for w in work)
    return 100.0 * bound / t


def bound_by(rec, peak, work_key: str) -> str:
    """Which peak bounds the kernel: ``operations`` or ``bytes``."""
    return counts.bound_s(*rec.traced["work"][0][work_key], peak)[1]
