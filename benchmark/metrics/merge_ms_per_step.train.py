"""Train step (train/loop.py tacotron_grads): milliseconds per traced
step in the program's train.merge spans, the deferred weight gradients
(ops/deferred.py) and, data-parallel, the gradient average. Host time,
dispatch and Python: the card idles most of this step, so the host's
phase times are the step."""

from benchmark.harness import spans


def read(run, ctx):
    return spans.ms_per_step(run, "train.merge")
