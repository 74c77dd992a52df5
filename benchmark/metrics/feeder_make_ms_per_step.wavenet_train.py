"""Feeder (data/wavenet_feeder.py WaveNetFeeder.batches, inline in the
training thread): milliseconds per traced step in the program's
feeder.featurize spans (an utterance's load, trim and mel, on a visit)
and feeder.make spans (a batch's stacking), host time the step waits
for. None where the program records no feeder.make span."""

from benchmark.harness import spans


def read(run, ctx):
    make = spans.ms_per_step(run, "feeder.make")
    if make is None:
        return None
    return make + (spans.ms_per_step(run, "feeder.featurize") or 0.0)
