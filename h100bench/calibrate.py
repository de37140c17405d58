"""Readings that the limits of ``correct`` are set from.

    python -m h100bench.calibrate --workload <cell> --seeds 1,2,3 --seconds 2 [--runs program,control,<fault>...]

For each seed, one short window of the cell as the harness runs it, in one
process: ``program`` is the port as it stands (a sound run), ``control``
puts the plain reference in the next lower precision in the program's
place, and each name of the cell runner's ``FAULTS`` breaks the timed path
underneath. Each run prints one JSON line with the numbers compared.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from h100bench import manifest as mf
from h100bench import run as run_mod


def readings(workload: str, seed: int, seconds: float, what: str, device: str = "cuda",
             config_patch=None, cell_patch=None) -> dict:
    """One run of the cell with ``what`` in force: its checks and correct."""
    man = mf.load()
    entry = mf.workload(man, workload)
    cell = {**mf.cell(entry["traffic"]), **(cell_patch or {})}
    config = {**mf.config(entry["config"]), **(config_patch or {})}
    runner = mf.runner(cell["runner"])
    if what == "program":
        ctx = contextlib.nullcontext()
    elif what == "control":
        ctx = runner.control(cell, config)
    else:
        ctx = runner.FAULTS[what](cell, config)
    with ctx:
        line = run_mod.execute(workload, seed, seconds, False, device=device, manifest=man,
                               config_patch=config_patch, cell_patch=cell_patch)
    return {"workload": workload, "seed": seed, "run": what, "correct": line["correct"],
            "checks": {k: v["value"] for k, v in line["checks"].items()}, "info": line["info"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--runs", default="program,control")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for what in args.runs.split(","):
            print(json.dumps(readings(args.workload, seed, args.seconds, what)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
