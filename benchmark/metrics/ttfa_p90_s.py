"""90th percentile over all streams of the window of the seconds from a
request's scheduled send to its first chunk on the host."""

from benchmark.harness.readers import latency, pct


def read(run, ctx):
    return pct(latency(run, "first"), 90)
