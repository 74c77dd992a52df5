"""Streaming pipeline (serving/streaming.py): median over groups of the
seconds from the start of a group's stream.prefix span to the end of
its first stream.launch span (the first chunk delivered; the program's
spans). The launch span closes at the chunk's delivery, after the host
waited for its copy, so it covers the device's first sampler launch."""

from benchmark.harness import spans
from benchmark.harness.readers import pct


def read(run, ctx):
    prefixes = spans.of("stream.prefix")
    launches = spans.of("stream.launch")
    if prefixes is None or launches is None:
        return None
    # a group's prefix and launches share their parent, its batcher.group
    start = {p.parent: p.t0_ns for p in prefixes if p.parent is not None}
    return pct([(f.t1_ns - start[f.parent]) * 1e-9 for f in launches
                if f.attrs.get("index") == 0 and f.parent in start], 50)
