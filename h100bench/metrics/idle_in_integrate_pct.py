"""Share of the traced window in which the device idled while the host
was inside ``rst.tsdf.integrate`` (mapping.tsdf's integrate_slots, one a
tick for every camera), split from the idle stretches by exact overlap
(spans.py). One reader for every cell group
(``idle_in_integrate_pct.<group>``)."""

from h100bench import spans


def read(run):
    return spans.idle_in_pct(run, spans.INTEGRATE)
