"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the measured
window, after ``reset_peak_memory_stats()`` at its start, in GiB."""


def read(rec, peak):
    return rec.peak_bytes / 2 ** 30 if rec.peak_bytes else None
