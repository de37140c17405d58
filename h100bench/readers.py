"""Shared arithmetic of the per-layer metric readers.

A reader is ``metrics/<name>.py`` (or, for a metric named ``<stem>.<cell
group>``, ``metrics/<stem>.py`` shared by every such name): a ``read(run)``
that takes a ``Traced`` run and returns a number, or None where it finds
nothing to read. A reader that needs what the port's functions were given
in the traced stretch declares it in ``RECORDS``: a log name mapped to
(module, function, keep), where ``keep(args, kwargs, result)`` keeps only
shapes and references, launching no device work. The runner records those
calls around its traced stretch and hands the logs over in ``run.logs``;
the reader counts the work from them itself, with roofline.py.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

from h100bench import roofline

COPIES = ("Memcpy", "Memset")


class Traced(NamedTuple):
    window: object  # trace.Window
    units: int  # pairs or frames the traced stretch finished
    config: dict  # the configuration as run
    logs: dict  # log name -> [keep(args, kwargs, result)] of each recorded call
    measured: dict  # host-clock readings of the measured window before it: "call_s", each call's seconds


def records_of(readers) -> dict:
    """The union of the readers' RECORDS (one log per name)."""
    out = {}
    for r in readers:
        for name, rec in getattr(r, "RECORDS", {}).items():
            out.setdefault(name, rec)
    return out


def resolve(records: dict) -> dict:
    """RECORDS with module names imported: name -> (module, function, keep)."""
    return {k: (importlib.import_module(m), fn, keep) for k, (m, fn, keep) in records.items()}


def matcher(names):
    return lambda n: any(k in n for k in names)


def idle_pct(run: Traced):
    """100 x (1 - union of device operations / the window's length)."""
    span = run.window.window_s()
    return None if span <= 0 else 100.0 * (1.0 - run.window.busy_s() / span)


def launches_per_unit(run: Traced):
    return None if run.units <= 0 or run.window.launches <= 0 else run.window.launches / run.units


def other_kernels_us_per_unit(run: Traced, handwritten):
    """Device microseconds per unit in kernels that are none of
    ``handwritten`` (copies and sets left out)."""
    own = matcher(handwritten)
    t = run.window.device_s(lambda n: not n.startswith(COPIES) and not own(n))
    return None if run.units <= 0 or t <= 0 else t * 1e6 / run.units


def roofline_pct(run: Traced, kernels, work):
    """100 x the least time for ``work`` (bytes, operations) / the traced
    device time of the kernels named; None where neither is there."""
    t = run.window.device_s(matcher(kernels))
    if t <= 0 or work is None or max(work) <= 0:
        return None
    return 100.0 * roofline.bound_s(*work) / t


def summed(works):
    """(bytes, operations) summed over an iterable of such pairs; None if empty."""
    total = None
    for w in works:
        total = tuple(w) if total is None else (total[0] + w[0], total[1] + w[1])
    return total
