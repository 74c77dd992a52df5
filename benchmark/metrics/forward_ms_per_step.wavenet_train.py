"""WaveNet train step (train/loop.py wavenet_grads): milliseconds per
traced step in the program's train.forward spans, the forward in
training mode (the conditioning upsampled on the card, the
teacher-forced logits) and the cross-entropy. Host time, dispatch and
Python, beside the card's work. None where the program records no such
span."""

from benchmark.harness import spans


def read(run, ctx):
    return spans.ms_per_step(run, "train.forward")
