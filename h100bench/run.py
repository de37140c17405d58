"""Run one cell of BENCHMARK.json once and print its result line.

    python -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, CUDA start, the port's kernel builds on a first run,
inputs made on the card from the seed, one warm call of every shape) is
timed as ``setup_s``; then the cell's calls run for ``--seconds``. With
``--trace 1`` a traced stretch follows the window and the line carries the
cell's per-layer metrics instead of its end-to-end ones. The outputs of the
timed path are then compared with the plain reference; each number
compared is printed beside its limit on standard error and under
``checks`` in the line. The last line of standard output is the result.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), or if JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "realsensetracker_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``modules`` (default sys.modules) that are JAX
    or the JAX package, compared whole: ``realsensetracker_tpu_torch`` is
    the port and passes."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            t_start: float | None = None, manifest: dict | None = None, config_patch: dict | None = None,
            cell_patch: dict | None = None) -> dict:
    """Run the cell and return its result line as a dict (the tests call
    this on the CPU with small patched sizes)."""
    from h100bench import manifest as mf
    from h100bench import readers

    man = manifest or mf.load()
    entry = mf.workload(man, workload)
    cfg = {**mf.config(entry["config"]), **(config_patch or {})}
    cell = {**mf.cell(entry["traffic"]), **(cell_patch or {})}
    layer = mf.per_layer(man, workload) if trace else []
    reader_of = {m["name"]: mf.metric(m["name"]) for m in layer}
    records = readers.resolve(readers.records_of(reader_of.values()))
    run = mf.runner(cell["runner"]).run(cell=cell, config=cfg, seed=seed, seconds=seconds, trace=trace,
                                        device=device, t_start=T_START if t_start is None else t_start,
                                        records=records)
    metrics, unread = {}, []
    for m in layer:
        value = reader_of[m["name"]].read(run["traced"])
        if value is None:
            unread.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if not trace:
        for m in mf.end_to_end(man, workload):
            metrics[m["name"]] = {"value": run["e2e"][m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": run["device_kind"], "count": 1, "memory_peak_bytes": run["memory_peak_bytes"]}
    if trace:
        win = run["traced"].window
        dev.update(busy_s=win.busy_s(), window_s=win.window_s())
    checks = {name: {"value": value, "limit": limit} for name, value, limit in run["checks"]}
    line = {"correct": bool(checks) and all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": run["attempted"], "failed": run["failed"], "metrics": metrics, "device": dev}
    if trace:
        from h100bench import trace as trace_mod

        line["breakdown"] = trace_mod.breakdown(run["traced"].window)
    line["info"] = run.get("info", {})
    if unread:
        # The cell lists these metrics, but what they read (a kernel by name,
        # or the recorded calls) was not in the traced stretch: left out.
        line["unread"] = unread
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from h100bench import manifest as mf

    man = mf.load()
    chips = int(mf.workload(man, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: {args.workload} needs {chips} CUDA card(s), this host has {have}; no result",
              file=sys.stderr)
        return 2
    line = execute(args.workload, args.seed, args.seconds, bool(args.trace), manifest=man)
    found = forbidden_modules()
    if found:
        print(f"h100bench: the run imported {', '.join(found)}; no result", file=sys.stderr)
        return 3
    line["device"]["power_limit"] = _power_limit()
    for name in line.get("unread", []):
        print(f"h100bench: per-layer metric {name} found nothing to read in {args.workload}; left out",
              file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
