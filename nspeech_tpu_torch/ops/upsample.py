"""Upsampling of frame-rate conditioning features to sample rate, on the
device that holds them (the frame-rate mel is ``hop`` times smaller to
move than the per-sample features)."""

from __future__ import annotations

import torch


def upsample_on_device(mels: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    """[N, T_frames, M] -> [N, length, M]: linear interpolation with frame
    t anchored at sample t*hop, edge-held past the last frame (the whole
    utterance: :func:`upsample_abs` from frame 0 and sample 0)."""
    return upsample_abs(mels, 0, 0, hop, length, mels.shape[1])


def upsample_abs(window: torch.Tensor, f0: int, s0: int, hop: int,
                 length: int, total_frames: int) -> torch.Tensor:
    """Upsample a mel ``window`` [N, W, M] holding frames f0 .. f0+W-1 of
    an utterance of ``total_frames`` frames to its samples [s0, s0+length)
    ([N, length, M]); ``s0`` need not be frame-aligned. Positions are
    absolute sample indices, so the result is :func:`upsample_on_device`
    over the whole utterance sliced to [s0, s0+length), bit for bit: a
    stream conditioned on it samples the codes of the one-shot vocode.

    The arithmetic is the JAX package's as XLA compiles it, so the vocoder
    sees bit-identical conditioning: the positions are float32
    ``arange * (1 / hop)`` (XLA turns the division by a constant into that
    product; exact below 2**24 samples in both packages) and the blend is
    one fused multiply-add, ``fma(m0, 1 - w, m1 * w)``, formed here with
    the product exact in float64 (the sum rounds through float64 to
    float32, which can differ from the fused single rounding only on rare
    halfway cases)."""
    pos = ((s0 + torch.arange(length, device=window.device)).to(torch.float32)
           * (1.0 / hop))
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, total_frames - 1)
    i1 = torch.clamp(i0 + 1, 0, total_frames - 1)
    w = (pos - i0.to(torch.float32))[None, :, None]
    m0, m1 = window[:, i0 - f0], window[:, i1 - f0]
    return (m0.double() * (1.0 - w).double() + (m1 * w).double()).float()
