"""WaveNet train step (train/loop.py wavenet_batch_to_device):
milliseconds per traced step in the program's train.to_device spans, the
batch's pinned host copies and their transfers. Host time, dispatch and
Python, beside the card's work. None where the program records no such
span."""

from benchmark.harness import spans


def read(run, ctx):
    return spans.ms_per_step(run, "train.to_device")
