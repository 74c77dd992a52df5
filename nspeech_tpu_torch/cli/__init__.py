"""Command-line entry points of the port, run as ``python -m
nspeech_tpu_torch.cli.<name>``."""
