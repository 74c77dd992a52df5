"""Feeder (data/feeder.py DataFeeder): milliseconds per step that the
loop waited for its next batch (the harness's span around taking it),
over the window's steps."""


def read(run, ctx):
    if not run.records:
        return None
    return 1000.0 * sum(r["t_batch"] - r["t0"] for r in run.records) / len(run.records)
