"""step_mfu: the whole step's share of the card's FP32 peak: the operations
the step's mathematics needs (``benchlib/counts.py``: the networks'
products from their shapes, the compositing's blended pairs, the
per-Gaussian, per-pixel and per-parameter work) over the step's device busy
time (the union of its device operations, each roofline step profiled
alone), in percent."""


def read(rec, peak):
    d, work = rec.traced.get("d"), rec.traced.get("work")
    if not peak or not d or not work:
        return None
    busy = sum(x["busy_s"] for x in d)
    if busy <= 0:
        return None
    return 100.0 * sum(w["step_ops"] for w in work) / busy / peak["fp32_flops"]
