"""s1_views_per_s: stage-1 training views stepped per second, every step of
the measured window (steps x cameras per step) over the whole window, which
ends in a synchronise; host clock."""


def read(rec, peak):
    return rec.views / rec.seconds if rec.seconds > 0 else None
