"""Feeder (data/feeder.py DataFeeder, its producer thread): milliseconds
per traced step in the program's feeder.make spans, the producer's host
time making examples and collating batches, which competes with the
step's dispatch for the interpreter lock."""

from benchmark.harness import spans


def read(run, ctx):
    return spans.ms_per_step(run, "feeder.make")
