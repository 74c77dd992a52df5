"""One run of a cell: set-up, the measured window, the device's peak
memory, the program's state freed, the correctness comparison, the
metrics. ``run.py`` adds the look for the card and prints the result;
the tests call :func:`execute` on the CPU at small sizes."""

from __future__ import annotations

import gc
import sys
from typing import List

import torch

from benchmark.harness import core, trace

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "nspeech_tpu")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(ctx: core.Ctx, t_start: float, metric_entries, driver=None) -> dict:
    """The result object of one run (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` and, traced, ``breakdown``), and
    under ``compared`` the numbers of the comparison with their limits."""
    driver = driver or core.module("traffic", ctx.params["kind"])
    cuda = ctx.device != "cpu"
    sut = driver.setup(ctx)
    setup_s = core.now() - t_start
    tracer = trace.Tracer() if (ctx.trace and cuda) else trace.NoTracer()
    run = driver.window(ctx, sut, tracer)
    run.info["setup_s"] = setup_s
    if ctx.trace and cuda:
        run.trace = tracer.summary()
    del tracer
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.close(sut)
    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    compared = driver.check(ctx, run)
    metrics = {}
    for m in metric_entries:
        value = core.module("metrics", m["name"]).read(run, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = sum(1 for r in run.records if "error" in r)
    result = {
        "correct": all(c.ok for c in compared) and failed == 0,
        "attempted": len(run.records),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["counters"] = {k: v for k, v in run.counters.items()
                          if isinstance(v, (int, float))}
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                          for c in compared}
    return result
