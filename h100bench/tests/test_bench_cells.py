"""Each cell driven on the CPU at a tiny size, the look for a card skipped:
sound runs are correct; the control (the reference in bfloat16 in the
program's place) and each fault planted under the timed path are not."""

import pytest

from h100bench import calibrate, run
from h100bench import manifest as mf
from h100bench.tests.tiny import TINY

CELLS = [w["name"] for w in mf.load()["workloads"]]
SEED = 2**32 + 2**31 + 77


def _readings(cell, what):
    config_patch, cell_patch = TINY[cell]
    return calibrate.readings(cell, SEED, 0.3, what, device="cpu", config_patch=config_patch,
                              cell_patch=cell_patch)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_reports_every_metric(cell):
    config_patch, cell_patch = TINY[cell]
    line = run.execute(cell, SEED, 0.3, False, device="cpu", config_patch=config_patch, cell_patch=cell_patch)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in mf.end_to_end(mf.load(), cell)}
    assert list(line)[-1] == "checks" and line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    assert not _readings(cell, "control")["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault):
    assert not _readings(cell, fault)["correct"]


def test_traced_run_reports_per_layer_metrics_and_breakdown():
    config_patch, cell_patch = TINY["pairs.fr1.b512"]
    line = run.execute("pairs.fr1.b512", SEED, 0.2, True, device="cpu", config_patch=config_patch,
                       cell_patch=cell_patch)
    assert line["correct"] and "breakdown" in line
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
    assert "device_idle_pct.pairs" in line["metrics"]
    assert set(line["metrics"]) <= {m["name"] for m in mf.per_layer(mf.load(), "pairs.fr1.b512")}


@pytest.mark.cuda
def test_one_cell_on_the_card(card):
    line = run.execute("pairs.fr1.b512", SEED, 1.0, True, device="cuda")
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    for name in ("launches_per_pair", "level_kernel_roofline.pairs", "gn_round_roofline.pairs"):
        assert name in line["metrics"]
    assert line["metrics"]["level_kernel_roofline.pairs"]["value"] <= 105


@pytest.mark.parametrize("cell", CELLS)
def test_rooflines_count_their_work_from_the_recorded_calls(cell):
    """A tiny traced CPU run records what each roofline's reader asks for;
    against a window in which its kernels ran 1 ms, each reads its work's
    least time over that millisecond."""
    import time

    from h100bench import readers, roofline
    from h100bench import trace as tracing

    man = mf.load()
    entry = mf.workload(man, cell)
    config_patch, cell_patch = TINY[cell]
    config = {**mf.config(entry["config"]), **config_patch}
    cell_def = {**mf.cell(entry["traffic"]), **cell_patch}
    rooflines = [m["name"] for m in mf.per_layer(man, cell) if "roofline" in m["name"]]
    reader_of = {name: mf.metric(name) for name in rooflines}
    # On the CPU the port runs these kernels' plain twins, with the same arguments.
    records = {k: (m, CPU_TWINS.get(fn, fn), keep)
               for k, (m, fn, keep) in readers.records_of(reader_of.values()).items()}
    run_out = mf.runner(cell_def["runner"]).run(
        cell=cell_def, config=config, seed=SEED, seconds=0.2, trace=True, device="cpu",
        t_start=time.perf_counter(), records=readers.resolve(records))
    traced = run_out["traced"]
    assert rooflines and all(traced.logs[k] for k in records)
    for name, reader in reader_of.items():
        kernels = [(k, 0.0, 1000.0) for k in reader.KERNELS]
        win = tracing.Window(0.0, 1e4, 0.01, kernels, 1, [])
        value = reader.read(traced._replace(window=win))
        assert value is not None and value > 0, name
        least = value / 100.0 * len(kernels) * 1e-3
        assert least == pytest.approx(roofline.bound_s(*_work_of(reader, traced)), rel=1e-9), name
        assert reader.read(traced._replace(window=win._replace(device=[]))) is None, name


CPU_TWINS = {"gn_round": "gn_round_reference", "build_level_packed": "build_level_packed_reference"}


def _work_of(reader, traced):
    """The (bytes, operations) a reader divides by, read back through a
    probe of readers.roofline_pct."""
    from h100bench import readers

    seen = []
    real = readers.roofline_pct
    readers.roofline_pct = lambda run, kernels, work: seen.append(work)
    try:
        reader.read(traced)
    finally:
        readers.roofline_pct = real
    return seen[0]
