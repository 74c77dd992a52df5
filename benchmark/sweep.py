"""The knee of a serving cell: one set-up, then one window per offered
rate, in turns from the lowest. For each rate it prints the requests
sent and completed, the latency percentiles from the due time (to the
first chunk for streams, to the whole answer otherwise), and the growth
of latency through the window (the median of the last quarter of
requests over that of the first): a backlog that grows reads well above
1. The cell's rate is then set at about four fifths of the highest rate
that holds without a growing backlog; the benchmark's own runs never
run this.

    python benchmark/sweep.py --workload <cell> --seed <n> --seconds 30 \
        --rates 0.6,0.8,1.0,1.2
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def summary(run, rate: float) -> dict:
    recs = sorted(run.records, key=lambda r: r["due"])
    key = "first" if any("first" in r for r in recs) else "done"
    lat = [r[key] - r["due"] for r in recs if key in r and "error" not in r]
    q = max(1, len(lat) // 4)
    return {"rate": rate, "sent": len(recs),
            "completed": len(lat),
            "p50_s": float(np.percentile(lat, 50)) if lat else None,
            "p90_s": float(np.percentile(lat, 90)) if lat else None,
            "growth": (float(np.median(lat[-q:]) / np.median(lat[:q]))
                       if len(lat) >= 4 else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core
    from benchmark.harness.trace import NoTracer
    entry = core.cell_entry(core.manifest(), args.workload)
    params = core.workload(args.workload)
    driver = core.module("traffic", params["kind"])
    ctx = core.Ctx(cell=args.workload, params=params,
                   config=core.config(entry["config"]), seed=args.seed,
                   seconds=args.seconds, trace=False, device="cuda")
    sut = driver.setup(ctx)
    for rate in (float(r) for r in args.rates.split(",")):
        ctx.params["rate"] = rate
        run = driver.window(ctx, sut, NoTracer())
        print(json.dumps(summary(run, rate)), flush=True)
    driver.close(sut)
    return 0


if __name__ == "__main__":
    sys.exit(main())
