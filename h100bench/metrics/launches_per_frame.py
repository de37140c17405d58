"""Kernel launches the host made per frame tracked and fused: the CUDA
runtime's launch records in the traced window over the frames (cameras x
ticks) it finished."""

from h100bench import readers


def read(run):
    return readers.launches_per_unit(run)
