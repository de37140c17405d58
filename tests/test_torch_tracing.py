"""The port's layer spans (utils/tracing.py) and the benchmark's readers of
them (h100bench/spans.py, the span metrics of BENCHMARK.json).

``span`` records a host event only while a torch profiler runs, nested as
placed and with no device-side twin; the benchmark's cells, run at the
tiny CPU sizes of h100bench/tests/tiny.py, show each span as often per
call as the paths make it; the idle split partitions the device's idle
stretches exactly. This file imports neither JAX nor the JAX package: on
a machine with a card,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

from __future__ import annotations

import time
from collections import Counter

import pytest
import torch

from h100bench import manifest as mf
from h100bench import readers, spans
from h100bench import trace as tracing
from h100bench.tests.tiny import TINY
from realsensetracker_tpu_torch.utils import tracing as rst_tracing
from realsensetracker_tpu_torch.utils.tracing import span

SEED = 2**33 + 2**31 + 17
MAN = mf.load()
NEW_METRICS = ("idle_outside_program_pct", "idle_in_register_pct", "idle_in_render_pct", "idle_in_integrate_pct",
               "dispatch_us", "sync_us")


def _profile(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("rst.")]


# --- the helper --------------------------------------------------------------


def test_fast_record_function_is_in_the_installed_torch():
    """span records through _RecordFunctionFast and has no fallback."""
    assert callable(getattr(torch._C._profiler, "_RecordFunctionFast", None))


def test_span_off_is_the_shared_null_context_and_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = span("rst.a"), span("rst.b")
    assert a is b is rst_tracing._OFF
    with a:
        with b:
            x = torch.ones(3) + 1
    assert float(x.sum()) == 6.0
    # A profiler started afterwards holds nothing of them.
    assert _profile(lambda: torch.ones(2) * 2) == []


def test_span_on_records_nested_host_ops_on_the_profilers_thread():
    def body():
        with span("rst.outer"):
            with span("rst.inner"):
                torch.ones(8).cumsum(0)
            torch.zeros(4) + 1

    events = {e.name: e for e in _profile(body)}
    assert set(events) == {"rst.outer", "rst.inner"}
    outer, inner = events["rst.outer"], events["rst.inner"]
    assert not outer.is_user_annotation and not inner.is_user_annotation
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "rst.outer"
    assert outer.time_range.start <= inner.time_range.start <= inner.time_range.end <= outer.time_range.end
    assert outer.thread == inner.thread
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in events.values())


def test_span_turns_on_and_off_with_the_profiler():
    assert span("rst.x") is rst_tracing._OFF
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert span("rst.x") is not rst_tracing._OFF
    assert span("rst.x") is rst_tracing._OFF


# --- the spans of the benchmarked paths, per call -------------------------------


def _traced_cell(cell):
    entry = mf.workload(MAN, cell)
    config_patch, cell_patch = TINY[cell]
    config = {**mf.config(entry["config"]), **config_patch}
    cell_def = {**mf.cell(entry["traffic"]), **cell_patch}
    out = mf.runner(cell_def["runner"]).run(cell=cell_def, config=config, seed=SEED, seconds=0.1, trace=True,
                                            device="cpu", t_start=time.perf_counter(), records={})
    return out["traced"], config, cell_def


def _inside(inner, outers):
    return any(a <= inner[1] and inner[2] <= b for _, a, b in outers)


def test_pairs_spans_per_chunked_call():
    traced, config, cell = _traced_cell("pairs.fr1.b512")
    host = [r for r in traced.window.host if r[0].startswith("rst.")]
    chunks = int(cell["batch"]) // int(cell["chunk"])
    assert int(cell["trace_calls"]) == 1 and chunks > 1
    assert Counter(n for n, _, _ in host) == {"rst.batched.register": 1 + chunks, "rst.projective.register": chunks,
                                              "rst.pyramid.build": chunks}
    entry = max((r for r in host if r[0] == "rst.batched.register"), key=lambda r: r[2] - r[1])
    assert all(_inside(r, [entry]) for r in host)
    registers = [r for r in host if r[0] == "rst.projective.register"]
    assert all(_inside(r, registers) for r in host if r[0] == "rst.pyramid.build")


@pytest.mark.parametrize("cell", ["kinfu512.16cam.live", "kinfu512.16cam.w8"])
def test_streams_spans_per_tick(cell):
    traced, config, cell_def = _traced_cell(cell)
    host = [r for r in traced.window.host if r[0].startswith("rst.")]
    ticks, s = int(cell_def["window"]) * int(cell_def["trace_calls"]), int(config["cameras"])
    assert Counter(n for n, _, _ in host) == {"rst.streams.step": int(cell_def["trace_calls"]),
                                              "rst.tsdf.render": ticks * s, "rst.projective.register": ticks,
                                              "rst.pyramid.build": ticks, "rst.tsdf.integrate": ticks}
    steps = [r for r in host if r[0] == "rst.streams.step"]
    assert all(_inside(r, steps) for r in host)
    registers = [r for r in host if r[0] == "rst.projective.register"]
    assert all(_inside(r, registers) for r in host if r[0] == "rst.pyramid.build")
    # Render, register and integrate are siblings: none overlaps another.
    layers = sorted((a, b) for n, a, b in host if n in spans.LAYERS)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(layers, layers[1:]))


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_tiny_traced_run_reports_every_span_metric(cell):
    from h100bench import run

    config_patch, cell_patch = TINY[cell]
    line = run.execute(cell, SEED, 0.1, True, device="cpu", config_patch=config_patch, cell_patch=cell_patch)
    listed = {m["name"] for m in mf.per_layer(MAN, cell) if m["name"].split(".", 1)[0] in NEW_METRICS}
    assert listed and line["correct"], line["checks"]
    assert listed <= set(line["metrics"]) and not listed & set(line.get("unread", []))
    metric = lambda stem: next(v["value"] for k, v in line["metrics"].items() if k.startswith(stem + "."))  # noqa: E731
    assert metric("dispatch_us") > 0 and metric("sync_us") == 0  # the CPU has no CUDA runtime records
    idle = metric("device_idle_pct")
    parts = metric("idle_outside_program_pct") + sum(
        v["value"] for k, v in line["metrics"].items() if k.startswith(("idle_in_",)))
    assert parts <= idle + 1e-9


# --- the split on hand-built windows ---------------------------------------------


def _window(device, host, lo=0.0, hi=100.0, units=4):
    win = tracing.Window(lo, hi, (hi - lo) * 1e-6, device, 0, sorted(host, key=lambda r: r[1]))
    return readers.Traced(win, units, {}, {}, {})


# A tick: step 10-90 holding render 12-30, register 32-60 (pyramid 33-40),
# integrate 62-80; a read-back 92-95 outside. Kernels run 0-11, 20-33,
# 50-64, 85-93; idle: 11-20, 33-50, 64-85, 93-100.
STEP_HOST = [("rst.streams.step", 10.0, 90.0), ("rst.tsdf.render", 12.0, 30.0),
             ("rst.projective.register", 32.0, 60.0), ("rst.pyramid.build", 33.0, 40.0),
             ("rst.tsdf.integrate", 62.0, 80.0), ("aten::copy_", 92.0, 95.0), ("cudaMemcpyAsync", 92.5, 94.5)]
STEP_DEVICE = [("k0", 0.0, 11.0), ("k1", 20.0, 33.0), ("k2", 50.0, 64.0), ("k3", 85.0, 93.0)]


def test_split_partitions_the_idle_exactly():
    run = _window(STEP_DEVICE, STEP_HOST)
    parts = spans.split(run.window)
    # 11-20: render 12-20 (8), glue 11-12 (1); 33-50: register 33-50 (17);
    # 64-85: integrate 64-80 (16), glue 80-85 (5); 93-100: outside 7.
    assert parts == pytest.approx({"outside": 7.0, spans.RENDER: 8.0, spans.REGISTER: 17.0, spans.INTEGRATE: 16.0,
                                   "glue": 6.0}, abs=1e-12)
    assert sum(parts.values()) == pytest.approx(readers.idle_pct(run), abs=1e-9)  # window of 100 us
    assert spans.idle_outside_pct(run) == pytest.approx(7.0)
    assert spans.idle_in_pct(run, spans.REGISTER) == pytest.approx(17.0)
    assert spans.idle_in_pct(run, spans.RENDER) == pytest.approx(8.0)
    assert spans.idle_in_pct(run, spans.INTEGRATE) == pytest.approx(16.0)


def test_a_stretch_straddling_two_spans_is_split_by_overlap():
    host = [("rst.batched.register", 0.0, 100.0), ("rst.tsdf.render", 10.0, 40.0),
            ("rst.projective.register", 40.0, 50.0)]
    run = _window([("k", 0.0, 30.0), ("k", 48.0, 100.0)], host)
    # The one idle stretch 30-48: 10 in render, 8 in register; its middle
    # (39) lies in render, which a midpoint rule would give all 18.
    assert spans.idle_in_pct(run, spans.RENDER) == pytest.approx(10.0)
    assert spans.idle_in_pct(run, spans.REGISTER) == pytest.approx(8.0)
    assert spans.idle_outside_pct(run) == pytest.approx(0.0)


def test_dispatch_counts_nested_spans_once_and_sync_only_inside_the_program():
    host = STEP_HOST + [("cudaStreamSynchronize", 70.0, 71.5), ("cudaLaunchKernel", 72.0, 72.5),
                        ("rst.streams.step", 96.0, 98.0)]
    run = _window(STEP_DEVICE, host, units=4)
    assert spans.dispatch_us(run) == pytest.approx((80.0 + 2.0) / 4)
    # The read-back's cudaMemcpyAsync (92.5-94.5) is the caller's.
    assert spans.sync_us(run) == pytest.approx(1.5 / 4)


def test_a_window_without_spans_reads_none_and_without_idle_reads_zero():
    bare = _window(STEP_DEVICE, [r for r in STEP_HOST if not r[0].startswith("rst.")])
    assert spans.split(bare.window) is None
    for read in (spans.idle_outside_pct, spans.dispatch_us, spans.sync_us,
                 lambda r: spans.idle_in_pct(r, spans.RENDER)):
        assert read(bare) is None
    busy = _window([("k", 0.0, 100.0)], STEP_HOST)
    assert spans.idle_outside_pct(busy) == 0.0 and spans.idle_in_pct(busy, spans.RENDER) == 0.0
    assert spans.idle_in_pct(busy, "rst.no.such.span") is None


@pytest.mark.parametrize("xs, ys, length", [
    ([(0, 10)], [(5, 15)], 5.0),
    ([(0, 10), (20, 30)], [(5, 25)], 10.0),
    ([(0, 1)], [(1, 2)], 0.0),
    ([(0, 100)], [(10, 20), (30, 40), (90, 120)], 30.0),
])
def test_overlap_of_stretch_lists(xs, ys, length):
    assert spans.overlap(xs, ys) == length
    assert spans.overlap(ys, xs) == length


def test_overlap_counts_nested_and_touching_stretches_once():
    nested = [(0, 10), (5, 6), (10, 12), (20, 21), (3, 3)]
    assert spans.overlap(nested, [(0, 100)]) == 13.0
    assert spans.overlap(nested, nested) == 13.0
    # Stretches that do not meet read exactly 0: a difference of unions
    # (|x| + |y| - |x u y|) reads -5.8e-11 on these microsecond stamps.
    xs = [(31377.762, 42435.825), (63460.577, 76970.705), (156198.991, 197384.856), (309670.053, 313830.52),
          (410461.827, 505420.374), (614532.529, 718440.477), (853942.488, 867779.034), (958659.426, 980635.757)]
    ys = [(44190.061, 44940.243), (88518.093, 150765.374), (284957.462, 293891.247), (330954.146, 407936.136),
          (599762.809, 610467.123), (768791.887, 800595.321), (872767.025, 880905.307), (989806.015, 998508.945)]
    assert spans.overlap(xs, ys) == 0.0


# --- the manifest's span metrics ---------------------------------------------------


SPAN_ENTRIES = [m for m in MAN["per_layer"] if m["name"].split(".", 1)[0] in NEW_METRICS]


@pytest.mark.parametrize("entry", SPAN_ENTRIES, ids=lambda m: m["name"])
def test_span_metric_entry_reads_spans_in_its_cells(entry):
    assert entry["source"] == "device_trace" and entry["better"] == "lower"
    assert mf.metric_file(entry["name"]).stem == entry["name"].split(".", 1)[0]
    assert entry["workloads"]
    for cell in entry["workloads"]:
        assert entry["moves"] in {m["name"] for m in mf.end_to_end(MAN, cell)}
    assert entry["unit"] == ("%" if entry["name"].startswith("idle_") else
                             {"pairs_per_s": "us/pair", "frames_per_s": "us/frame"}[entry["moves"]])


def test_there_are_ten_span_metrics():
    assert len(SPAN_ENTRIES) == 10


# --- on the card ----------------------------------------------------------------------


@pytest.mark.cuda
def test_spans_add_no_device_record_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from realsensetracker_tpu_torch.align import projective
    from realsensetracker_tpu_torch.geometry import camera
    from realsensetracker_tpu_torch.parallel import batched

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    dst = 1.0 + 0.5 * torch.rand((8, 120, 160), generator=g, device=dev)
    src = dst + 0.001 * torch.randn(dst.shape, generator=g, device=dev)
    intr = camera.Intrinsics(130.0, 130.0, 79.5, 59.5, 160, 120)
    cfg = projective.ProjectiveIcpConfig(samples=512, min_samples=64)
    batched.register_batch_chunked(src, dst, intr, cfg, chunk=4).transform.cpu()
    win = tracing.traced(lambda: batched.register_batch_chunked(src, dst, intr, cfg, chunk=4).transform.cpu())
    assert win.device and not [n for n, _, _ in win.device if n.startswith("rst.")]
    assert Counter(n for n, _, _ in win.host if n.startswith("rst."))["rst.batched.register"] == 3
