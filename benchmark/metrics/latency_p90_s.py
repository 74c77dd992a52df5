"""90th percentile over all requests of the window of the seconds from a
request's scheduled send to its whole waveform on the host."""

from benchmark.harness.readers import latency, pct


def read(run, ctx):
    return pct(latency(run, "done"), 90)
