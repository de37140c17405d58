"""Named spans at the port's layer boundaries, for torch.profiler.

``with span("rst.tsdf.render"): ...`` records the block as one host event
in the trace of a running torch.profiler (``utils.profiling.device_trace``,
``rs_benchmark --profile``, the benchmark's ``--trace 1``), on the
profiler's own clock, nested under the span around it and on the thread
that ran it; the trace written at the profiler's end holds it. With no
profiler running, ``span`` returns one shared null context and records
nothing: there is no switch of its own.

The event comes from ``torch._C._profiler._RecordFunctionFast``: an
ordinary host op, not a user annotation, so CUDA tracing gives it no
device-side twin among the kernels (its cost, off and on: PERF.md). A span
launches nothing, synchronizes nothing and allocates nothing on the
device.

Spans of the benchmarked paths, each placed inside its function's body:

    rst.batched.register     parallel/batched.py register_batch(_chunked)
    rst.streams.step         parallel/streams.py step_tsdf_streams(_window)
    rst.projective.register  align/projective.py register_depth_pair
    rst.pyramid.build        ops/pyramid.py build_pyramid
    rst.tsdf.render          mapping/tsdf.py render_model_depth
    rst.tsdf.integrate       mapping/tsdf.py integrate_slots
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` while a torch profiler
    runs, else the shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
