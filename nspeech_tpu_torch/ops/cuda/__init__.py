"""Hand-written CUDA kernels (sources in ``nspeech_tpu_torch/csrc``), their
build and their PyTorch wrappers."""
