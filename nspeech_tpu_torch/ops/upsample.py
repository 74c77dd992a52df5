"""Upsampling of frame-rate conditioning features to sample rate, on the
device that holds them (the frame-rate mel is ``hop`` times smaller to
move than the per-sample features)."""

from __future__ import annotations

import torch


def upsample_on_device(mels: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    """[N, T_frames, M] -> [N, length, M]: linear interpolation with frame
    t anchored at sample t*hop, edge-held past the last frame.

    The arithmetic is the JAX package's as XLA compiles it, so the vocoder
    sees bit-identical conditioning: the positions are float32
    ``arange(length) * (1 / hop)`` (XLA turns the division by a constant
    into that product) and the blend is one fused multiply-add,
    ``fma(m0, 1 - w, m1 * w)``, formed here with the product exact in
    float64 (the sum rounds through float64 to float32, which can differ
    from the fused single rounding only on rare halfway cases)."""
    t_frames = mels.shape[1]
    pos = torch.arange(length, dtype=torch.float32, device=mels.device) * (1.0 / hop)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, t_frames - 1)
    i1 = torch.clamp(i0 + 1, 0, t_frames - 1)
    w = (pos - i0.to(torch.float32))[None, :, None]
    m0, m1 = mels[:, i0], mels[:, i1]
    return (m0.double() * (1.0 - w).double() + (m1 * w).double()).float()
