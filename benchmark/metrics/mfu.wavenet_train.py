"""Whole WaveNet train step: percent of the float32 peak that the traced
steps' FLOPs reach over the traced span. FLOPs: the frozen count of
benchmark/harness/wavenet_flops.py (each layer at the positions the
scored samples need, the skip products and head at the scored samples,
the backward twice the forward), the same for every step."""

from benchmark.harness.readers import share


def read(run, ctx):
    tr = run.info["traced"]
    if run.trace is None or not tr.get("steps"):
        return None
    return share(run.info["flops_per_step"] * tr["steps"], run.trace["window_s"])
