"""strands_it_per_s: strand-stage steps per second, every step of the
measured window over the whole window, which ends in a synchronise; host
clock."""


def read(rec, peak):
    return rec.steps / rec.seconds if rec.seconds > 0 else None
