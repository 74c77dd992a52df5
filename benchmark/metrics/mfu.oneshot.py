"""Whole serving step: percent of the float32 peak that the served work
inside the traced span reaches over it: Tacotron-1 to the linear
spectrogram for real rows, plus Griffin-Lim's FFTs at 5 N log2 N (each
group counted by the part of its span inside the trace)."""

from benchmark.harness.readers import share


def read(run, ctx):
    if run.trace is None:
        return None
    return share(run.info["flops"], run.trace["window_s"])
