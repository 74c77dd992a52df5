"""Train step (train/loop.py batch_to_device): milliseconds per traced
step in the program's train.to_device spans, the batch's pinned host
copies and their transfers. Host time, dispatch and Python: the card
idles most of this step, so the host's phase times are the step."""

from benchmark.harness import spans


def read(run, ctx):
    return spans.ms_per_step(run, "train.to_device")
