"""Feeder (data/feeder.py DataFeeder.batches): milliseconds per traced
step in the program's feeder.take spans, the consumer's wait on the
prefetch queue's get (host clock). It measures only that wait: host
time the loop loses around it, between its next() and the get, is not
in the span (feeder_wait_ms_per_step.train, the harness's span around
next(), holds it)."""

from benchmark.harness import spans


def read(run, ctx):
    return spans.ms_per_step(run, "feeder.take")
