"""Batcher (serving/batcher.py StreamBatcher): mean rows (streams) per
group dispatched, from the program's batcher.group spans. A group holds
what arrived while the one before it ran; a sampler step costs about
the same for one row as for eight, so more rows are more audio per
launch."""

from benchmark.harness import spans


def read(run, ctx):
    recs = spans.of("batcher.group")
    return None if recs is None else sum(r.attrs["rows"] for r in recs) / len(recs)
