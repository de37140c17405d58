"""BENCHMARK.json is well formed and every name resolves to its own file."""

import json
import re

import pytest

from h100bench import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = mf.load()


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["h100bench"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(MAN["command"]) <= 32 and all(not w.startswith("/") and ".." not in w for w in MAN["command"])
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in MAN[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        group = [x["name"] for x in MAN[k]]
        assert len(group) == len(set(group)), k
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in MAN["workloads"]] + [c["source"] for c in MAN["configs"]] + \
            [m["layer"] for m in MAN["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    cfg = mf.config(entry["name"])
    assert entry["file"] == f"h100bench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["assumed"] and cfg["source"]
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("entry", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(entry):
    cell = mf.cell(entry["traffic"])
    runner = mf.runner(cell["runner"])
    assert callable(runner.run) and callable(runner.control)
    assert set(runner.FAULTS) >= {"state_unchanged", "half_batch", "answer_altered"}
    assert entry["chips"] == 1
    e2e = [m["name"] for m in mf.end_to_end(MAN, entry["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert mf.per_layer(MAN, entry["name"])
    assert set(cell["limits"])


@pytest.mark.parametrize("entry", MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(entry):
    reader = mf.metric(entry["name"])
    assert callable(reader.read)
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert entry["moves"] in e2e
    for cell in entry["workloads"]:
        assert cell in [m for m in e2e[entry["moves"]].get("workloads", [cell])]
    if "roofline" in entry["name"]:
        assert entry["unit"] == "%" and entry["better"] == "higher"


def test_each_reader_file_serves_a_listed_metric():
    used = {mf.metric_file(m["name"]).name for m in MAN["per_layer"]}
    files = {p.name for p in (mf.HERE / "metrics").glob("*.py")}
    assert files == used
    assert mf.metric_file("device_idle_pct.pairs") == mf.metric_file("device_idle_pct.frames")
    with pytest.raises(FileNotFoundError):
        mf.metric_file("no_such_metric.pairs")


@pytest.mark.parametrize("entry", MAN["per_layer"], ids=lambda m: m["name"])
def test_reader_records_name_functions_of_the_port(entry):
    import importlib

    for module, fn, keep in getattr(mf.metric(entry["name"]), "RECORDS", {}).values():
        assert callable(getattr(importlib.import_module(module), fn)) and callable(keep)
