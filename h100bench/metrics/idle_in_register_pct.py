"""Share of the traced window in which the device idled while the host
was inside ``rst.projective.register`` (align.projective's
register_depth_pair, its pyramid build included), split from the idle
stretches by exact overlap (spans.py). One reader for every cell group
(``idle_in_register_pct.<group>``)."""

from h100bench import spans


def read(run):
    return spans.idle_in_pct(run, spans.REGISTER)
