"""Acoustic model and Griffin-Lim (serving/synthesizer.py): median over
groups of the seconds of a synthesize_batch call (encoder, decode,
post-CBHG, Griffin-Lim, the waveforms to the host)."""

from benchmark.harness.readers import pct


def read(run, ctx):
    return pct([g["t1"] - g["t0"] for g in run.info["groups"] if "t1" in g], 50)
