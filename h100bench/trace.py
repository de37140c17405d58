"""A traced window: torch.profiler's device and host records, reduced.

``traced(fn)`` runs ``fn`` once under ``torch.profiler`` (host and CUDA
activity) inside a ``h100bench.window`` span and returns a ``Window``: the
device operations (kernels, copies, sets) that ran inside the span, the
runtime's kernel launches, and the host operations, on the profiler's
clock in microseconds, with the span's wall length.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import NamedTuple

import torch

from h100bench import stats

WINDOW_SPAN = "h100bench.window"
# Records that are the profiler's own, not work: the device-side copy of a
# host annotation spans the kernels under it.
PROFILER_OWN = ("h100bench.", "Activity Buffer Request")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


class Window(NamedTuple):
    start_us: float
    end_us: float
    wall_s: float  # host clock around the traced call, synchronized
    device: list  # [(name, start_us, end_us)] of every device operation in the window
    launches: int  # runtime kernel launches in the window
    host: list  # [(name, start_us, end_us)] host operations, sorted by start

    def busy_s(self) -> float:
        return stats.union_length([(a, b) for _, a, b in self.device]) * 1e-6

    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def device_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.device if match(n)) * 1e-6


def traced(fn) -> Window:
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
    events = prof.events()
    span = [e for e in events if e.name == WINDOW_SPAN and e.device_type == torch.autograd.DeviceType.CPU]
    if not span:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = span[0].time_range.start, span[0].time_range.end
    device, host, launches = [], [], 0
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if b < lo or a > hi:
            continue
        if e.name.startswith(PROFILER_OWN):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((e.name, max(a, lo), min(b, hi)))
        else:
            host.append((e.name, a, b))
            if e.name.startswith(LAUNCH_PREFIXES):
                launches += 1
    host.sort(key=lambda x: x[1])
    return Window(lo, hi, wall, device, launches, host)


def traced_recorded(fn, records: dict):
    """(Window, logs): ``fn`` run twice with every call of ``records``
    (hooks.recorded) kept, the second time traced. The first pass, untraced,
    grows the allocator's pool by what the logs keep alive, so that the
    traced pass allocates nothing new; its logs are dropped."""
    from h100bench import hooks

    with hooks.recorded(records):
        fn()
    with hooks.recorded(records) as logs:
        win = traced(fn)
    return win, logs


def _label(host: list, starts: list, t: float) -> str:
    """The innermost host operation running at time t (the latest-starting
    one among the 64 before it that has not ended), else 'python'."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 65, -1), -1):
        name, a, b = host[j]
        if b >= t:
            return name
    return "python"


def breakdown(win: Window, top: int = 10) -> dict:
    """The device operations that took most time, and the idle stretches
    of the device summed by what the host was doing in their middle: each
    a list of at most ``top`` [name, seconds]."""
    by_op = defaultdict(float)
    for name, a, b in win.device:
        by_op[name[:160]] += (b - a) * 1e-6
    starts = [a for _, a, _ in win.host]
    by_host = defaultdict(float)
    for a, b in stats.gaps([(x, y) for _, x, y in win.device], win.start_us, win.end_us):
        by_host[_label(win.host, starts, 0.5 * (a + b))[:160]] += (b - a) * 1e-6
    order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": order(by_op), "idle_gaps": order(by_host)}
