"""Readings for the limits of a cell's correctness comparison: for each
seed, the program's numbers (set-up, a window, the comparison) and the
control's (the reference computed in TF32 put in the program's place),
or with ``--fault`` the numbers of the program with that fault planted
(the traffic driver's ``FAULTS``). All seeds run in one process.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 20 \
        [--fault NAME] [--out FILE]

One JSON line per seed on standard output (and appended to ``--out``).
The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(ctx, driver, fault=None) -> dict:
    """{"program": {name: value}, "control": {...}} for one seed; with a
    ``fault``, the program's numbers with it planted."""
    import contextlib

    import torch
    plant = driver.FAULTS[fault] if fault else contextlib.nullcontext
    with plant():
        sut = driver.setup(ctx)
        from benchmark.harness.trace import NoTracer
        run = driver.window(ctx, sut, NoTracer())
        driver.close(sut)
    del sut
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    out = {"program": {c.name: c.value for c in driver.check(ctx, run)},
           "failed": sum(1 for r in run.records if "error" in r),
           "attempted": len(run.records)}
    if not fault:
        out["control"] = {c.name: c.value for c in driver.check(ctx, run, control=True)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core
    entry = core.cell_entry(core.manifest(), args.workload)
    params = core.workload(args.workload)
    driver = core.module("traffic", params["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = core.Ctx(cell=args.workload, params=params,
                       config=core.config(entry["config"]), seed=seed,
                       seconds=args.seconds, trace=False, device="cuda")
        t = time.perf_counter()
        line = {"seed": seed, "fault": args.fault, **readings(ctx, driver, args.fault),
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
