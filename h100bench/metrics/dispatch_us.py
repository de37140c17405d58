"""Host microseconds per pair or frame inside the port's outermost
``rst.`` spans (the union of every span): the host's cost to enqueue the
traced stretch's work, waits included (``sync_us`` counts those). One
reader for every cell group (``dispatch_us.<group>``)."""

from h100bench import spans


def read(run):
    return spans.dispatch_us(run)
