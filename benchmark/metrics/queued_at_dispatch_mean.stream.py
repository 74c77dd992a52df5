"""Batcher (serving/batcher.py StreamBatcher): mean requests left in the
batcher's queue when a group is dispatched, beyond the group's own
max_batch rows, from the program's batcher.group spans."""

from benchmark.harness import spans


def read(run, ctx):
    recs = spans.of("batcher.group")
    return None if recs is None else sum(r.attrs["queued"] for r in recs) / len(recs)
