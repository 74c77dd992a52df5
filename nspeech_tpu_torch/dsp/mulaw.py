"""Mu-law companding codec (ITU-T G.711 style), on tensors.

:func:`mu_law_encode` reproduces, bit for bit, what the JAX package's
``mu_law_encode`` gives when it runs op by op on the CPU (as its CLIs call
it): XLA lowers f32 ``log1p`` to a Cephes-style rational approximation for
arguments under sqrt(2) - 1 and to its own polynomial ``log(1 + y)`` above,
neither correctly rounded, and contracts their multiply-adds into FMAs.
The library ``log1p`` of torch or numpy rounds differently in about 0.1% of
the values in [0, 255], which moves a code by one step on a rounding edge.
So the encoder evaluates XLA's arithmetic in numpy float32, with each FMA
rounded once (:func:`_fma`). Encoding runs on the host: it sees a seed
wav of a few thousand samples. :func:`mu_law_decode` reads a table built
with the C library's ``powf``, which XLA's CPU ``pow`` calls, so decoding
equals the JAX package's too.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

_F32 = np.float32


def _c(bits: int) -> np.float32:
    """A float32 constant from its 32-bit pattern."""
    return np.array([bits], np.uint32).view(_F32)[0]


# XLA's CPU log(v), v > 0 normal: frexp-style reduction to x in
# [sqrt(.5) - 1, sqrt(2) - 1), a degree-9 polynomial in three Horner
# strands, and e * ln 2 split in two parts.
_LOG_P = [_c(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F,
                          0x3E11E9BF, 0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC,
                          0x3EAAAAAA)]
_LOG_Q1, _LOG_Q2 = _c(0xB95E8083), _c(0x3F318000)     # -2.12194440e-4, 0.693359375
_SQRT_HALF = _c(0x3F3504F3)
# XLA's log1p(y) for |y| < sqrt(2) - 1: y - y^2/2 + y^3 * N(y) / D(y).
_LOG1P_SMALL = _c(0x3ED413CD)
_LOG1P_NUM = [_c(b) for b in (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                              0x4273CC76, 0x426473AD, 0x41A05101)]
_LOG1P_DEN = [_c(b) for b in (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
                              0x43586D8A, 0x42707982)]


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once: the product is exact in float64;
    the sum is rounded to odd in float64 (its error found by TwoSum), so
    the final rounding to float32 is the correct one."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(odd, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(_F32)


def _xla_log(v: np.ndarray) -> np.ndarray:
    v = np.maximum(v, _c(0x00800000))
    bits = v.view(np.int32)
    e = ((bits >> 23) - 127).astype(_F32) + _F32(1)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)
    low = m < _SQRT_HALF
    x = (m + _F32(-1)) + np.where(low, m, _F32(0))
    e = np.where(low, e - _F32(1), e)
    z = x * x
    x3 = z * x
    p = _LOG_P
    a = _fma(_fma(x, p[0], p[1]), x, p[2])
    b = _fma(_fma(x, p[3], p[4]), x, p[5])
    c = _fma(_fma(x, p[6], p[7]), x, p[8])
    tail = _fma(_fma(_fma(a, x3, b), x3, c), x3, e * _LOG_Q1)
    return _fma(e, _LOG_Q2, _fma(-z, _F32(0.5), x) + tail)


def _xla_log1p(y: np.ndarray) -> np.ndarray:
    """XLA's CPU ``log1p`` of float32 ``y >= 0`` (finite)."""
    y = np.asarray(y, _F32)
    den = y * _F32(0) + _F32(1)
    for k in _LOG1P_DEN:
        den = _fma(den, y, k)
    num = y * _F32(0) + _LOG1P_NUM[0]
    for k in _LOG1P_NUM[1:]:
        num = _fma(num, y, k)
    y2 = y * y
    small = y + _fma(y2, _F32(-0.5), (y * y2) * (num / den))
    return np.where(np.abs(y) < _LOG1P_SMALL, small, _xla_log(y + _F32(1)))


def mu_law_encode(audio, quantization_channels: int) -> torch.Tensor:
    """float waveform in [-1, 1] -> int32 codes in [0, Q-1] (a tensor on
    ``audio``'s device; computed on the host)."""
    device = audio.device if isinstance(audio, torch.Tensor) else "cpu"
    if isinstance(audio, torch.Tensor):
        audio = audio.detach().cpu().numpy()
    audio = np.asarray(audio, _F32)
    mu = _F32(quantization_channels - 1)
    magnitude = (_xla_log1p(np.minimum(np.abs(audio), _F32(1)) * mu)
                 / _xla_log1p(np.array([mu]))[0])
    signal = np.sign(audio) * magnitude
    # Quantize: shift to [0, mu], round half up via +0.5 then truncate.
    codes = ((signal + _F32(1)) / _F32(2) * mu + _F32(0.5)).astype(np.int32)
    return torch.from_numpy(codes).to(device)


@functools.lru_cache(maxsize=None)
def _decode_table(quantization_channels: int, device: torch.device) -> torch.Tensor:
    """The Q decoded levels in float32 on ``device``, built once. XLA's CPU
    ``pow`` calls the C library's ``powf``; so does this table, so it
    equals the JAX decode. The copy to a card is asynchronous (from pinned
    memory): a copy from pageable memory would hold the host until the
    work queued before it, such as a sampler launch, had finished."""
    powf = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").powf
    powf.argtypes = [ctypes.c_float, ctypes.c_float]
    powf.restype = ctypes.c_float
    mu = _F32(quantization_channels - 1)
    signal = _F32(2) * (np.arange(quantization_channels, dtype=_F32) / mu) - _F32(1)
    power = np.array([powf(_F32(1) + mu, v) for v in np.abs(signal)], _F32)
    table = torch.from_numpy(np.sign(signal) * ((_F32(1) / mu) * (power - _F32(1))))
    if device.type == "cuda":
        table = table.pin_memory().to(device, non_blocking=True)
    return table


def mu_law_decode(codes: torch.Tensor, quantization_channels: int) -> torch.Tensor:
    """int codes in [0, Q-1] -> float waveform in [-1, 1], through a table
    of the Q values: a code decodes to the same float wherever it stands
    (a vectorised ``pow`` on the CPU can round a vector's tail otherwise),
    so a stream decoded chunk by chunk equals the one-shot decode."""
    codes = torch.as_tensor(codes)
    table = _decode_table(quantization_channels, codes.device)
    return table[codes.to(torch.int64)]
