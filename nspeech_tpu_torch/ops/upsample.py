"""Upsampling of frame-rate conditioning features to sample rate, on the
device that holds them (the frame-rate mel is ``hop`` times smaller to
move than the per-sample features)."""

from __future__ import annotations

import torch

from nspeech_tpu_torch.config import stft_params


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


def upsample_window(mel_frames: torch.Tensor, phase: torch.Tensor, hop: int,
                    length: int) -> torch.Tensor:
    """Per-row phase-aligned upsample of training windows: ``mel_frames``
    [B, F, M] are the frame rows covering each window, the first row
    anchored ``phase[b]`` samples before the window's start (0 <= phase <
    hop); returns [B, length, M], positions past the last row holding its
    value. The arithmetic is the JAX package's ``upsample_window`` as XLA
    compiles it inside the train step (as in :func:`upsample_abs`): the
    positions are float32 ``(phase + j) * (1 / hop)`` and the blend is one
    fused multiply-add, so the conditioning equals JAX's bit for bit."""
    f = mel_frames.shape[1]
    j = torch.arange(length, device=mel_frames.device).to(torch.float32)
    pos = (phase.to(torch.float32)[:, None] + j) * (1.0 / hop)      # [B, L]
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, f - 1)
    i1 = torch.clamp(i0 + 1, 0, f - 1)
    w = torch.clamp(pos - i0.to(torch.float32), 0.0, 1.0)[..., None]
    rows = torch.arange(mel_frames.shape[0], device=mel_frames.device)[:, None]
    m0, m1 = mel_frames[rows, i0], mel_frames[rows, i1]
    return (m0.double() * (1.0 - w).double() + (m1 * w).double()).float()


def batch_lc(batch, cfg) -> torch.Tensor:
    """Per-sample local conditioning of a WaveNet batch in either layout:
    the legacy per-sample ``mel`` [B, window, M] passes through; frame-rate
    rows (``mel_phase`` set) get :func:`upsample_window` to the window's
    length, at ``cfg``'s hop."""
    if batch.mel_phase is None:
        return batch.mel
    return upsample_window(batch.mel, batch.mel_phase, stft_params(cfg)[1],
                           batch.audio.shape[1])
