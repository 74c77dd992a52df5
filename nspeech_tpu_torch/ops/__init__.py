"""Layers, upsampling, the Philox noise source and the CUDA kernels."""
