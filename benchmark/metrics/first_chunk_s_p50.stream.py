"""Streaming pipeline (serving/streaming.py): median over groups of the
seconds from a group's start to its first chunk (encoder, prefix decode,
first postnet window, first sampler launch)."""

from benchmark.harness.readers import pct


def read(run, ctx):
    return pct([g["t_first"] - g["t0"] for g in run.info["groups"] if "t_first" in g], 50)
