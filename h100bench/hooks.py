"""Temporary replacement and recording of module attributes.

The harness reads what the port's functions were given and returned by
wrapping them for a stretch, and the control and the planted faults put
other code in the port's place; on leaving, the originals are back.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(module, **attrs):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


@contextlib.contextmanager
def recording(module, name: str, log: list, keep):
    """Each call of module.name appends keep(args, kwargs, result) to
    ``log``: only what is kept stays alive."""
    real = getattr(module, name)

    def rec(*args, **kwargs):
        out = real(*args, **kwargs)
        log.append(keep(args, kwargs, out))
        return out

    with patched(module, **{name: rec}):
        yield


@contextlib.contextmanager
def recorded(records: dict):
    """Record every call of each of ``records`` (log name -> (module,
    function name, keep)) for a stretch; yields {log name: list}."""
    logs = {k: [] for k in records}
    with contextlib.ExitStack() as stack:
        for name, (module, fn, keep) in records.items():
            stack.enter_context(recording(module, fn, logs[name], keep))
        yield logs
