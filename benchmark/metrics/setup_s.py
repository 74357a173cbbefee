"""setup_s: seconds from the process's start to the end of warm-up (inputs,
weights, the port's state, its kernels' build on a first run, the checked
steps and the warm-up steps), on the host's clock."""


def read(rec, peak):
    return rec.setup_s
