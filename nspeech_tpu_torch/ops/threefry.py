"""JAX's default PRNG in numpy: Threefry-2x32, ``split`` and float32
``uniform``.

The port draws Griffin-Lim's initial phase from it, so that its phase, and
with it the waveform and the endpoint that trims the vocoder's input, are
the JAX package's (whose synthesizer draws ``uniform(split(PRNGKey(0),
n)[i], shape)`` per row). It reproduces ``jax.random`` with the default
``threefry2x32`` implementation and ``jax_threefry_partitionable=True``,
the default of JAX 0.5 and later (JAX 0.9.0 is the version held to in the
tests). In that variant a key ``(k0, k1)`` draws element j of an array
from ``threefry2x32(key, (hi(j), lo(j)))`` of the element's flat row-major
index j as a 64-bit counter split into two 32-bit words: ``split`` keeps
both output words as the new key, 32-bit ``random_bits`` xors them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the counter words ``(x0, x1)``
    (uint32 arrays of one shape) under ``key``; returns two uint32 arrays."""
    k = [np.asarray(key[0], np.uint32), np.asarray(key[1], np.uint32)]
    k.append(k[0] ^ k[1] ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + k[0]
        x1 = np.asarray(x1, np.uint32) + k[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + k[(i + 1) % 3]
            x1 = x1 + k[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): (0, seed)."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return 0, int(seed)


def _counters(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The flat row-major index of each element as (hi, lo) uint32 words."""
    j = np.arange(int(np.prod(shape, dtype=np.int64)),
                  dtype=np.uint64).reshape(tuple(shape))
    return (j >> np.uint64(32)).astype(np.uint32), j.astype(np.uint32)


def split(key: Tuple[int, int], num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32 [num, 2], one key per row."""
    b0, b1 = threefry2x32(key, *_counters((num,)))
    return np.stack([b0, b1], axis=1)


def uniform(key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), from the top
    23 bits of each 32-bit draw as the mantissa of a float in [1, 2)."""
    b0, b1 = threefry2x32((int(key[0]), int(key[1])), *_counters(shape))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    return np.maximum(bits.view(np.float32) - np.float32(1.0), np.float32(0.0))
