"""10th percentile over streams of the audio seconds after the first
chunk over the seconds from the first chunk to the last: below 1 the
listener's playback starves. A failed stream counts as 0."""

from benchmark.harness.readers import pct


def read(run, ctx):
    sr = float(run.info["sample_rate"])
    vals = []
    for r in run.records:
        if "error" in r or r.get("last", 0) <= r.get("first", 0):
            vals.append(0.0)
            continue
        vals.append((r["samples"] - r["first_samples"]) / sr / (r["last"] - r["first"]))
    return pct(vals, 10)
