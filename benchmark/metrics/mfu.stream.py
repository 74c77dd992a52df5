"""Whole serving step: percent of the float32 peak that the served work
reaches over the traced window (the window and the drain of its
streams): Tacotron-2's encoder, decode and postnet for real rows plus
the sampler's 3.45 MFLOP per delivered sample and stream."""

from benchmark.harness.readers import share


def read(run, ctx):
    if run.trace is None:
        return None
    f = run.info["flops"]
    return share(f["taco"] + f["sampler"], run.trace["window_s"])
