"""The 95th percentile of the measured window's calls, in ms, on the host
clock: in the live cell each call is a tick, from its frames handed in to
its poses on the host. Read from the window that precedes the traced
stretch, so the profiler does not touch it. One reader for every cell
group (``tick_ms_p95.<group>``)."""

from h100bench import stats


def read(run):
    calls = run.measured.get("call_s", [])
    return stats.percentile(calls, 95) * 1e3 if calls else None
