"""Train step (train/loop.py build_tacotron_train_step): milliseconds per
traced step in the program's train.update spans, the gradient norms,
the clip, Adam, the parameters' update and the EMA. Host time, dispatch
and Python: the card idles most of this step, so the host's phase
times are the step."""

from benchmark.harness import spans


def read(run, ctx):
    return spans.ms_per_step(run, "train.update")
