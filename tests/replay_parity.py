"""Shared helpers of the replay parity tests (tests/test_torch_replay*.py):
both packages' rs_replay run in-process on the same files, each JAX run
once per module (a cache keyed by its arguments), the port's on the CPU."""

import contextlib
import io
import json

import numpy as np

from realsensetracker_tpu.cli import rs_replay as jreplay
from realsensetracker_tpu_torch.cli import rs_replay

TRAJ_BAR = 1e-4  # trajectory files and --json poses, port vs JAX


class Run:
    """One rs_replay.main call: exit code, stdout, stderr, --json rows and
    the other printed lines."""

    def __init__(self, main, argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                self.rc = main(argv)
            except SystemExit as e:  # argparse
                self.rc = e.code
        self.out, self.err = out.getvalue(), err.getvalue()
        self.rows = [json.loads(ln) for ln in self.out.splitlines() if ln.startswith("{")]
        self.lines = [ln for ln in self.out.splitlines() if not ln.startswith("{")]

    def line(self, prefix: str) -> str:
        return next(ln for ln in self.lines if ln.startswith(prefix))


class Runner:
    """Runs both packages on one argv; JAX's runs are cached."""

    def __init__(self):
        self._jax = {}

    def jax(self, argv) -> Run:
        key = tuple(argv)
        if key not in self._jax:
            self._jax[key] = Run(jreplay.main, list(argv))
        return self._jax[key]

    def port(self, argv) -> Run:
        return Run(rs_replay.main, list(argv) + ["--device", "cpu"])


def assert_same_trajectory(path_a, path_b, bar=TRAJ_BAR):
    a, b = np.loadtxt(path_a, ndmin=2), np.loadtxt(path_b, ndmin=2)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, 0], b[:, 0])  # timestamps
    assert np.abs(a - b).max() <= bar


def assert_same_rows(rows, jrows, bar=TRAJ_BAR):
    assert len(rows) == len(jrows) > 0
    for r, j in zip(rows, jrows):
        assert r.keys() == j.keys()
        assert (r["frame"], r["timestamp"], r["success"], r["kf"]) == (j["frame"], j["timestamp"], j["success"], j["kf"])
        assert np.abs(np.asarray(r["pose"]) - np.asarray(j["pose"])).max() <= bar


def processed(run: Run) -> int:
    return int(run.line("processed ").split()[1])
