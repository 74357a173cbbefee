"""instances_per_view: the port's own count of the (Gaussian, tile)
instances it binned (``num_rendered``), per camera, averaged over the
steps of the traced run's window."""


def read(rec, peak):
    if not rec.num_rendered:
        return None
    return sum(rec.num_rendered) / (len(rec.num_rendered) * rec.views_per_step)
