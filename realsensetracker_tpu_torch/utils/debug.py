"""Debugging aides: NaN guards and numeric checks.

Port of realsensetracker_tpu/utils/debug.py. The reference scatters manual
NaN checks through the pipeline ("NANI!?", align_gicp.cpp:146-154; NaN->0
in conversion, rs_driver.cpp:84-88; RemoveNans). The port handles NaNs
structurally (masks and finite guards in the solvers); these helpers are
the debugging counterparts of JAX's:

* ``debug_nans`` raises at the first op whose floating output holds a NaN,
  as ``jax_debug_nans`` does. ``torch.autograd.detect_anomaly`` is not the
  same thing: it checks only the backward pass.
* ``check_finite`` and ``count_nonfinite`` report non-finite values.

Every check of a CUDA tensor's values reads a flag back to the host, which
waits for the card to finish the work queued before it: use them to
debug, not on a timed path.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class _NanCheck(TorchDispatchMode):
    """Runs each op, then raises if a floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the scope, raise FloatingPointError at the first op that
    produces a NaN (each op's outputs are checked on its device)."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield


def check_finite(x, name: str = "value"):
    """Print a warning when x holds a non-finite value; returns x unchanged
    (insertable into pipelines without effect). Prints only on violation."""
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        print(f"[check_finite] {name}: non-finite VALUES PRESENT")
    return x


def count_nonfinite(tree) -> dict:
    """Host-side audit: count non-finite elements per floating leaf of a
    nested dict / list / tuple / NamedTuple, keyed by its path."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k, v in zip(x._fields, x):
                walk(v, f"{path}.{k}")
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif x is not None:
            arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            if arr.dtype.kind in "fc":
                out[path] = int((~np.isfinite(arr)).sum())

    walk(tree, "")
    return out
