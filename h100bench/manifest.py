"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

``BENCHMARK.json`` (at the root of the checkout) names the cells, their
configuration and traffic, and the metrics. A configuration is
``configs/<config>.json``, a traffic mix ``cells/<traffic>.json`` (whose
``runner`` names ``runners/<runner>.py``), a per-layer metric
``metrics/<metric>.py`` or, for a metric ``<stem>.<cell group>``, the
reader ``metrics/<stem>.py`` that every group shares. Adding a cell or a
metric adds files; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def cell(traffic: str) -> dict:
    return json.loads((HERE / "cells" / f"{traffic}.json").read_text())


def runner(name: str):
    return importlib.import_module(f"h100bench.runners.{name}")


def metric_file(name: str) -> Path:
    """``metrics/<name>.py``, else ``metrics/<stem>.py`` for a name
    ``<stem>.<cell group>``: one reader serves the metric in every group."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r} under {HERE / 'metrics'}")
    return path


def metric(name: str):
    """The reader module of a per-layer metric."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(f"h100bench.metrics.{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in(metric_entry: dict, cell_name: str) -> bool:
    return "workloads" not in metric_entry or cell_name in metric_entry["workloads"]


def end_to_end(manifest: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in manifest["end_to_end"] if _in(m, cell_name)]


def per_layer(manifest: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, or that
    list no cells and move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
