"""Streaming pipeline (serving/streaming.py StreamingTTS.stream_batch):
90th percentile over groups of the seconds from the call's entry to its
admission, the wait for room on the card for its streams' sampler
clusters (the program's stream.admit spans). A program without the span
reads None."""

from benchmark.harness import spans
from benchmark.harness.readers import pct


def read(run, ctx):
    recs = spans.of("stream.admit")
    return None if recs is None else pct([spans.seconds(r) for r in recs], 90)
