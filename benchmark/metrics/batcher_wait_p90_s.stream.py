"""Batcher (serving/batcher.py StreamBatcher): 90th percentile of the
seconds a request waited inside the batcher, from its enqueue to the
start of its group's stream_batch call (the program's batcher.wait
spans; host clock, the wait for the running group and the window)."""

from benchmark.harness import spans
from benchmark.harness.readers import pct


def read(run, ctx):
    recs = spans.of("batcher.wait")
    return None if recs is None else pct([spans.seconds(r) for r in recs], 90)
