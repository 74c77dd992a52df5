"""Device: percent of the traced WaveNet steps' span in which no kernel
or copy ran on the card (torch.profiler)."""

from benchmark.harness.readers import device_idle


def read(run, ctx):
    return device_idle(run)
