"""Batcher (serving/batcher.py StreamBatcher): 90th percentile of the
seconds from a request's scheduled send to the start of its group's
stream_batch call (the harness's proxy)."""

from benchmark.harness.readers import pct


def read(run, ctx):
    return pct([r["group_t0"] - r["due"] for r in run.records if "group_t0" in r], 90)
