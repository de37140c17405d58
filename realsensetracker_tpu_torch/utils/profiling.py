"""Profiling utilities.

Port of realsensetracker_tpu/utils/profiling.py. The reference sprinkles
cho::util::UTimer stopwatches through the hot path (align_icp.cpp:81-93).
Here: the same microsecond stopwatch for host code, a per-stage aggregator
for pipeline reports, and a torch.profiler trace with a Chrome-trace
export for device profiling.

CUDA work is asynchronous: a stage that launched kernels has finished only
when the device has. StageTimes therefore synchronizes the device of every
CUDA tensor a stage hands in before it stops the clock; CPU tensors need
nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class UTimer:
    """Microsecond stopwatch (cho::util::UTimer analog, align_icp.cpp:81)."""

    def __init__(self, start: bool = True):
        self._t0 = time.perf_counter() if start else None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop_and_get_elapsed_time(self) -> float:
        """Elapsed microseconds since start."""
        return (time.perf_counter() - self._t0) * 1e6


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in x (nested tuples, lists, dicts)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    return out


class StageTimes:
    """Accumulate named stage durations; report mean/total per stage."""

    def __init__(self):
        self._times = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a stage. Yields a list: append the stage's outputs to it and
        the devices of its CUDA tensors are synchronized before the clock
        stops::

            with times.stage("gn") as out:
                T, rmse = solve(...)
                out.append((T, rmse))
        """
        outputs: list = []
        t0 = time.perf_counter()
        yield outputs
        for dev in _cuda_devices(outputs, set()):
            torch.cuda.synchronize(dev)
        self._times[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._times[name].append(seconds)

    def report(self) -> dict:
        return {
            name: {
                "count": len(v),
                "mean_ms": 1e3 * sum(v) / len(v),
                "total_ms": 1e3 * sum(v),
            }
            for name, v in self._times.items()
        }


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
