"""Plain references of the benchmark's configurations: PyTorch and NumPy
only, written from the published descriptions and the parameter layout
the benchmark's weights use. Nothing here imports ``jax``, ``nspeech_tpu``
or ``nspeech_tpu_torch``; where the served path's arithmetic is part of
its contract (the Griffin-Lim phase draw, the sampler's noise, mu-law) a
frozen copy lives here.

:func:`precision` runs a block in float32 with TF32 off (the reference)
or on (the control, one step of precision below what the configurations
state).
"""

from __future__ import annotations

import contextlib

import torch

_TF32 = [False]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest); the gradient
    passes through as through the identity."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The references' every product: ``a @ b`` in float32, its operands
    rounded to TF32 first inside ``precision(tf32=True)``, as the card's
    TF32 products take them (on any device, so the control runs the same
    on the CPU)."""
    if _TF32[0]:
        a, b = _tf32(a), _tf32(b)
    return torch.matmul(a, b)


@contextlib.contextmanager
def precision(tf32: bool):
    """The references' products in float32 (``tf32`` False, TF32 off in
    cuBLAS and cuDNN) or in TF32 (the control); the previous state is
    restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, _TF32[0])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _TF32[0] = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _TF32[0]) = saved
