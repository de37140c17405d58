"""Host microseconds per pair or frame that the port itself waits for the
card: the CUDA runtime's synchronize and memcpy records (spans.SYNCS)
inside its ``rst.`` spans. Above zero, the port holds a synchronization
of its own. One reader for every cell group (``sync_us.<group>``)."""

from h100bench import spans


def read(run):
    return spans.sync_us(run)
