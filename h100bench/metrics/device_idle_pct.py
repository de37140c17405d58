"""Share of the traced window in which no operation ran on the device:
100 x (1 - union of device kernel, copy and set intervals / the window's
length). One reader for every cell group (``device_idle_pct.<group>``)."""

from h100bench import readers


def read(run):
    return readers.idle_pct(run)
