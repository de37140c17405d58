"""The run refuses JAX and the JAX package, and a host without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from h100bench import run

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["jax", "jax.numpy", "numpy"]) == ["jax"]
    assert run.forbidden_modules(["realsensetracker_tpu.align.projective"]) == ["realsensetracker_tpu"]
    assert run.forbidden_modules(["jaxlib.xla_client", "flax.linen"]) == ["flax", "jaxlib"]
    assert run.forbidden_modules(["realsensetracker_tpu_torch", "realsensetracker_tpu_torch.align",
                                  "jaxtyping", "torch"]) == []


def _run(cwd, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", "pairs.fr1.b512",
                           "--seed", str(2**33 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not obj.get("correct") and "device" not in obj and "metrics" not in obj


def test_no_card_exits_without_a_result():
    proc = _run(ROOT)
    _no_result(proc)
    assert "CUDA" in proc.stderr


def test_benchmark_alone_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))
