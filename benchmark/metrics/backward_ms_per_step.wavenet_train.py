"""WaveNet train step (train/loop.py wavenet_grads): milliseconds per
traced step in the program's train.backward spans, autograd's gradients
of the loss. Host time, dispatch and Python, beside the card's work.
None where the program records no such span."""

from benchmark.harness import spans


def read(run, ctx):
    return spans.ms_per_step(run, "train.backward")
