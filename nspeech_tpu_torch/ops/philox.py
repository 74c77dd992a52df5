"""Counter-based Philox4x32-10 and the Gumbel noise the WaveNet sampler
draws from it.

The CUDA sampler (``csrc/wavenet_gen.cu``) computes the same function, so
the kernel and its plain PyTorch version draw identical noise: for
stream ``b`` at sample ``t``, code ``q`` takes word ``q % 4`` of
``philox(counter=(q // 4, t, b, 0), key=(seed_lo, seed_hi))``.

Products of two 32-bit words are formed from 16-bit halves so that every
intermediate fits a signed 64-bit integer.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit words of m * a for 32-bit m and int64 a < 2^32."""
    x = m * (a >> 16)                   # < 2^48
    y = m * (a & 0xFFFF)                # < 2^48
    hi = (x + (y >> 16)) >> 16
    lo = (((x & 0xFFFF) << 16) + y) & _MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32 with 10 rounds on int64 tensors holding 32-bit words."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def gumbel_noise(seed: int, t: torch.Tensor, batch: int, q: int) -> torch.Tensor:
    """Gumbel(0, 1) noise [len(t), batch, q] float32 for sample indices
    ``t`` (int tensor) of streams 0..batch-1."""
    if q % 4:
        raise ValueError(f"quantization_channels={q} must be a multiple of 4")
    dev = t.device
    j = torch.arange(q // 4, dtype=torch.int64, device=dev)[None, None, :]
    tt = t.to(torch.int64)[:, None, None]
    b = torch.arange(batch, dtype=torch.int64, device=dev)[None, :, None]
    shape = (t.shape[0], batch, q // 4)
    words = philox4x32(j.expand(shape), tt.expand(shape), b.expand(shape),
                       torch.zeros(shape, dtype=torch.int64, device=dev),
                       seed & _MASK, (seed >> 32) & _MASK)
    bits = torch.stack(words, dim=-1).reshape(t.shape[0], batch, q)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-10
    return -torch.log(-torch.log(u))
