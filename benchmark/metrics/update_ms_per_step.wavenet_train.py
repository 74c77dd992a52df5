"""WaveNet train step (train/loop.py build_wavenet_train_step):
milliseconds per traced step in the program's train.update spans, the
clip and Adam over the parameters' leaves, the norms and the EMA. Host
time, dispatch and Python, beside the card's work. None where the
program records no such span."""

from benchmark.harness import spans


def read(run, ctx):
    return spans.ms_per_step(run, "train.update")
