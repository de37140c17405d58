"""The port's layer spans in a traced window, and what they cover.

While a profiler runs, the port records a host span at each layer boundary
of its benchmarked paths (``rst.batched.register``, ``rst.streams.step``,
``rst.projective.register``, ``rst.pyramid.build``, ``rst.tsdf.render``,
``rst.tsdf.integrate``). They arrive among ``Window.host``'s records, on
the profiler's clock like the device's. Here the device's idle stretches
(``stats.gaps`` over ``Window.device``: the stretches that
``device_idle_pct`` counts) are split by their exact overlap with the
spans, never by where a stretch's middle falls, and the host's time inside
the spans is summed.

The outermost spans are the program's entries: the union of every
``rst.`` span is the time the host spent inside the port. Idle outside
that union is the caller's (reading results back, its loop). Idle inside
it is that of the named layers (render, register, integrate: siblings
that never overlap) plus the glue between them.

A window with no ``rst.`` span at all (a program without spans) reads
None everywhere; a window with spans but no idle in one reads 0.
"""

from __future__ import annotations

from h100bench import stats

PREFIX = "rst."
RENDER, REGISTER, INTEGRATE = "rst.tsdf.render", "rst.projective.register", "rst.tsdf.integrate"
LAYERS = (RENDER, REGISTER, INTEGRATE)
# Runtime calls in which the host waits for the card.
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
                   "cudaMemcpyAsync"))


def _merged(intervals) -> list:
    """Sorted, disjoint (start, end) stretches covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def overlap(xs, ys) -> float:
    """Length of the intersection of the union of ``xs`` with the union of
    ``ys`` ((start, end) stretches, overlaps counted once), summed from the
    overlapping pieces alone: stretches that do not meet add exactly 0."""
    xs, ys = _merged(xs), _merged(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def named(win, name: str | None = None) -> list:
    """The (start, end) of the window's host records named ``name``, or of
    every ``rst.`` span where ``name`` is None."""
    if name is None:
        return [(a, b) for n, a, b in win.host if n.startswith(PREFIX)]
    return [(a, b) for n, a, b in win.host if n == name]


def idle(win) -> list:
    """The device's idle stretches of the window."""
    return stats.gaps([(a, b) for _, a, b in win.device], win.start_us, win.end_us)


def split(win) -> dict | None:
    """Device idle microseconds of the window by where the host was:
    ``outside`` every span, inside each of ``LAYERS``, and ``glue`` (inside
    the program, in none of them); they sum to the idle. None without
    spans."""
    program = named(win)
    if not program:
        return None
    gaps = idle(win)
    total = stats.union_length(gaps)
    inside = overlap(gaps, program)
    out = {"outside": total - inside}
    out.update({name: overlap(gaps, named(win, name)) for name in LAYERS})
    out["glue"] = inside - sum(out[name] for name in LAYERS)
    return out


def _pct(win, us):
    span = win.end_us - win.start_us
    return None if span <= 0 else 100.0 * us / span


def idle_outside_pct(run):
    """100 x device idle while the host is inside no span / the window."""
    parts = split(run.window)
    return None if parts is None else _pct(run.window, parts["outside"])


def idle_in_pct(run, name: str):
    """100 x device idle while the host is inside a span ``name`` (and the
    spans nested in it) / the window; None where no such span ran."""
    stretches = named(run.window, name)
    return _pct(run.window, overlap(idle(run.window), stretches)) if stretches else None


def dispatch_us(run):
    """Host microseconds per unit inside the program's outermost spans."""
    program = named(run.window)
    if not program or run.units <= 0:
        return None
    return stats.union_length(program) / run.units


def sync_us(run):
    """Host microseconds per unit inside the program's spans spent in the
    runtime calls that wait for the card (``SYNCS``)."""
    program = named(run.window)
    if not program or run.units <= 0:
        return None
    waits = [(a, b) for n, a, b in run.window.host if n in SYNCS]
    return overlap(waits, program) / run.units
