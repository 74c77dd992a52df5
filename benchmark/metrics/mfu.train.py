"""Whole train step: percent of the float32 peak that the traced steps'
FLOPs reach over the traced span. FLOPs: the frozen Tacotron-2 count
(forward, weight and input gradients of every product), summed over the
rows at each row's own unpadded lengths, so padding neither adds nor
removes work."""

from benchmark.harness.readers import share


def read(run, ctx):
    tr = run.info["traced"]
    if run.trace is None or not tr.get("steps"):
        return None
    k0 = tr["step0"]
    f = sum(run.info["flops_per_step"][k0:k0 + tr["steps"]])
    return share(f, run.trace["window_s"])
