"""Batcher (serving/batcher.py StreamBatcher over serving/streaming.py):
percent of the groups admitted while other groups still streamed, from
the program's stream.admit spans (attribute ``inflight``, the padded rows
streaming at admission). A program that runs one group at a time records
no such span and reads None."""

from benchmark.harness import spans


def read(run, ctx):
    recs = spans.of("stream.admit")
    if recs is None:
        return None
    return 100.0 * sum(r.attrs["inflight"] > 0 for r in recs) / len(recs)
