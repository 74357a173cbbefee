"""step_ms_p95: the 95th percentile of the step times of the traced run's
unprofiled window.  A step is delimited by the host's clock at the return
of consecutive step calls (the first from the window's start); no
synchronisation is added beyond the one the step makes itself (the
binning's read of its instance count), so a step's time includes waiting
for the device's work that the step queued before that read."""
import statistics


def read(rec, peak):
    if len(rec.step_s) < 20:
        return None
    return 1e3 * statistics.quantiles(rec.step_s, n=20)[18]
