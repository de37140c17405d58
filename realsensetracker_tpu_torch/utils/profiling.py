"""Device traces.

Port of realsensetracker_tpu/utils/profiling.py's trace: a torch.profiler
run with a Chrome-trace export. Host timing inside the port is done by the
spans of utils/tracing.py, which the profiler records on its own clock
beside the card's kernels; nothing here synchronizes the card.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def device_trace(log_dir: str, name: str = "trace.json"):
    """Trace the host and, where CUDA is present, the card with
    torch.profiler; on exit the trace is written to ``log_dir/name`` in
    Chrome's trace format (chrome://tracing, Perfetto). Yields the
    profiler, whose events() and key_averages() stay readable after."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, name))
