"""Kernel launches the host made per registered pair: the CUDA runtime's
launch records in the traced window (torch's and the port's own kernels,
cudaLaunchKernel and cudaLaunchKernelEx) over the pairs registered. One
reader for ``launches_per_pair`` and ``launches_per_pair.<group>``."""

from h100bench import readers


def read(run):
    return readers.launches_per_unit(run)
