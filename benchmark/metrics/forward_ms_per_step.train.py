"""Train step (train/loop.py tacotron_grads): milliseconds per traced
step in the program's train.forward spans, the forward in training mode
and the loss. Host time, dispatch and Python: the card idles most of
this step, so the host's phase times are the step."""

from benchmark.harness import spans


def read(run, ctx):
    return spans.ms_per_step(run, "train.forward")
