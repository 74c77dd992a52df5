"""Mu-law companding codec (ITU-T G.711 style), on tensors."""

from __future__ import annotations

import math

import torch


def mu_law_encode(audio: torch.Tensor, quantization_channels: int) -> torch.Tensor:
    """float waveform in [-1, 1] -> int32 codes in [0, Q-1]."""
    mu = float(quantization_channels - 1)
    audio = torch.as_tensor(audio, dtype=torch.float32)
    safe_abs = torch.clamp(audio.abs(), max=1.0)
    magnitude = torch.log1p(mu * safe_abs) / math.log1p(mu)
    signal = torch.sign(audio) * magnitude
    # Quantize: shift to [0, mu], round half up via +0.5 then truncate.
    return ((signal + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def mu_law_decode(codes: torch.Tensor, quantization_channels: int) -> torch.Tensor:
    """int codes in [0, Q-1] -> float waveform in [-1, 1], through a table
    of the Q values: a code decodes to the same float wherever it stands
    (a vectorised ``pow`` on the CPU can round a vector's tail otherwise),
    so a stream decoded chunk by chunk equals the one-shot decode."""
    codes = torch.as_tensor(codes)
    mu = float(quantization_channels - 1)
    levels = torch.arange(quantization_channels, dtype=torch.float32,
                          device=codes.device)
    signal = 2.0 * (levels / mu) - 1.0
    magnitude = (1.0 / mu) * (torch.pow(1.0 + mu, signal.abs()) - 1.0)
    return (torch.sign(signal) * magnitude)[codes.to(torch.int64)]
