"""Share of the traced window in which the device idled while the host
was inside no ``rst.`` span of the port: the caller's own time (reading
the transforms or poses back, its loop), split from the idle stretches
by exact overlap (spans.py). One reader for every cell group
(``idle_outside_program_pct.<group>``)."""

from h100bench import spans


def read(run):
    return spans.idle_outside_pct(run)
