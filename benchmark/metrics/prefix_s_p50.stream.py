"""Streaming pipeline (serving/streaming.py StreamingTTS.stream_batch):
median over groups of the seconds from the call's entry to its first
read of the stop flags (the program's stream.prefix spans). That read
waits for the card, so the span covers the device's encoder, prefix
decode and first postnet window, not only their dispatch."""

from benchmark.harness import spans
from benchmark.harness.readers import pct


def read(run, ctx):
    recs = spans.of("stream.prefix")
    return None if recs is None else pct([spans.seconds(r) for r in recs], 50)
