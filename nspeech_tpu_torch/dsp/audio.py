"""Signal processing: the featurizer (wav -> linear and mel spectrograms)
and the synthesis side (STFT/ISTFT, Griffin-Lim, inverse pre-emphasis and
endpointing).

Port of ``nspeech_tpu/dsp/audio.py``, with the same conventions: periodic
Hann window of ``win_length`` zero-padded centrally to ``n_fft``, the
signal reflect-padded by ``n_fft // 2``, and the ISTFT overlap-add divided
by ``max(squared-window envelope, 1e-10)`` (written out with
``index_add_`` rather than ``torch.istft``, which checks NOLA and
normalises differently). Griffin-Lim runs the FFT form of the reference
on a batch of spectrograms. The featurizer (:func:`spectrograms`) is input
pipeline work and runs on the host CPU, as the JAX package pins it there.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nspeech_tpu_torch.config import Config, stft_params
from nspeech_tpu_torch.dsp.mel import mel_filterbank


def periodic_hann(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _padded_window(n_fft: int, win_length: int, device) -> torch.Tensor:
    window = periodic_hann(win_length)
    lpad = (n_fft - win_length) // 2
    return torch.from_numpy(
        np.pad(window, (lpad, n_fft - win_length - lpad))).to(device)


def num_frames(n_samples: int, n_fft: int, hop_length: int) -> int:
    """Frame count for a center-padded signal of n_samples."""
    return 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop_length


def preemphasis(x: np.ndarray, coef: float) -> np.ndarray:
    """Host-side y[n] = x[n] - coef * x[n-1] in float32 (the first sample
    passes through)."""
    x = np.asarray(x, dtype=np.float32)
    return np.concatenate([x[:1], x[1:] - coef * x[:-1]])


def amp_to_db(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=1e-5))


def normalize(S: torch.Tensor, min_level_db: float) -> torch.Tensor:
    return torch.clamp((S - min_level_db) / -min_level_db, 0.0, 1.0)


def spectrograms(y, cfg: Config) -> Tuple[np.ndarray, np.ndarray]:
    """Linear [T, num_freq] and mel [T, num_mels] spectrograms (time-major,
    float32 numpy) of a waveform, with the reference's dB scaling and [0, 1]
    normalization.

    Runs on the host CPU by design: featurization is input-pipeline work
    (the data feeder's prefetch thread and the feature cache), and the JAX
    package pins it to its CPU backend for the same reason. Pre-emphasis
    and the reflect centering by ``n_fft // 2`` (zero padding for a signal
    no longer than that) run in numpy on the exact-length signal; then the
    frames' ``|rfft|``, ``normalize(amp_to_db(mag) - ref_level_db)`` for
    the linear path and ``normalize(amp_to_db(mag @ mel_basis.T))`` for the
    mel path (no ``ref_level_db`` there), both against a floor of
    ``-|min_level_db|``. The JAX package pads the centred signal up to a
    16,384-sample bucket to bound its recompiles and keeps the same frames.
    """
    n_fft, hop_length, win_length = stft_params(cfg)
    emph = preemphasis(y, cfg.preemphasis)
    pad = n_fft // 2
    mode = "reflect" if emph.shape[0] > pad else "constant"
    frames = torch.from_numpy(np.pad(emph, (pad, pad), mode=mode)).unfold(
        0, n_fft, hop_length)
    window = _padded_window(n_fft, win_length, "cpu")
    mag = torch.fft.rfft(frames * window, dim=-1).abs()
    mel_basis = torch.from_numpy(
        mel_filterbank(cfg.sample_rate, n_fft, cfg.num_mels))
    floor = -abs(cfg.min_level_db)
    linear = normalize(amp_to_db(mag) - cfg.ref_level_db, floor)
    mel = normalize(amp_to_db(mag @ mel_basis.T), floor)
    return linear.numpy(), mel.numpy()


def spectrogram(y, cfg: Config) -> np.ndarray:
    return spectrograms(y, cfg)[0]


def melspectrogram(y, cfg: Config) -> np.ndarray:
    return spectrograms(y, cfg)[1]


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def denormalize(S: torch.Tensor, min_level_db: float) -> torch.Tensor:
    return torch.clamp(S, 0.0, 1.0) * -min_level_db + min_level_db


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """[..., T] -> complex STFT [..., n_frames, 1 + n_fft//2] (time-major)."""
    lead = y.shape[:-1]
    pad = n_fft // 2
    yp = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")[:, 0]
    frames = yp.unfold(-1, n_fft, hop_length)
    window = _padded_window(n_fft, win_length, y.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    return spec.reshape(*lead, *spec.shape[-2:])


def istft(stft_matrix: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int) -> torch.Tensor:
    """[..., n_frames, 1 + n_fft//2] -> [..., (n_frames-1)*hop]: overlap-add
    normalised by the squared-window envelope, centering pad trimmed."""
    lead = stft_matrix.shape[:-2]
    n = stft_matrix.shape[-2]
    window = _padded_window(n_fft, win_length, stft_matrix.device)
    frames = torch.fft.irfft(stft_matrix, n=n_fft, dim=-1) * window
    frames = frames.reshape(-1, n * n_fft)
    total = n_fft + hop_length * (n - 1)
    idx = (torch.arange(n, device=frames.device)[:, None] * hop_length
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    y = frames.new_zeros(frames.shape[0], total).index_add_(1, idx, frames)
    wss = frames.new_zeros(total).index_add_(0, idx, (window * window).repeat(n))
    y = y / torch.clamp(wss, min=1e-10)
    pad = n_fft // 2
    return y[:, pad: total - pad].reshape(*lead, total - 2 * pad)


def _gl_iterate(project, y0, iters: int, momentum: float):
    """``iters`` Griffin-Lim projections from ``y0``; ``momentum`` > 0 is
    the fast-Griffin-Lim extrapolation (the projected iterate is returned)."""
    if momentum:
        c, t_prev = y0, y0
        for _ in range(iters):
            t = project(c)
            c, t_prev = t + momentum * (t - t_prev), t
        return t_prev
    y = y0
    for _ in range(iters):
        y = project(y)
    return y


def griffin_lim(S_norm: torch.Tensor, cfg: Config, phase: torch.Tensor) -> torch.Tensor:
    """Normalized linear spectrograms [..., T, F] -> waveforms via
    Griffin-Lim from the initial phase ``phase`` (uniform in [0, 1), same
    shape as ``S_norm``, in turns)."""
    n_fft, hop, win = stft_params(cfg)
    S = db_to_amp(denormalize(S_norm, -abs(cfg.min_level_db)) + cfg.ref_level_db)
    S = torch.pow(S, cfg.power).to(torch.complex64)
    angles = torch.exp(2j * math.pi * phase)
    y = istft(S * angles, n_fft, hop, win)

    def project(y):
        est = stft(y, n_fft, hop, win)
        return istft(S * (est / torch.clamp(est.abs(), min=1e-8)), n_fft, hop, win)

    return _gl_iterate(project, y, cfg.griffin_lim_iters,
                       float(cfg.get("griffin_lim_momentum", 0.0)))


def inv_spectrogram(S_norm: torch.Tensor, cfg: Config,
                    phase: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Waveform(s) from normalized linear spectrogram(s) [..., T, F]. The
    initial phase is ``phase`` or else drawn from ``generator``. Does not
    invert pre-emphasis (see :func:`inv_preemphasis`)."""
    S_norm = S_norm.to(torch.float32)
    if phase is None:
        phase = torch.rand(S_norm.shape, generator=generator,
                           device=S_norm.device)
    return griffin_lim(S_norm, cfg, phase)


def inv_preemphasis(x: torch.Tensor, coef: float, block: int = 256) -> torch.Tensor:
    """Inverse pre-emphasis y[n] = x[n] + coef * y[n-1] over the last axis.

    Blocked on the device: inside each block of ``block`` samples the
    recurrence is one matmul with the lower-triangular Toeplitz matrix of
    ``coef^(i-j)``; the blocks' last values then obey the same recurrence
    with ``coef^block``, solved the same way, and carry into the next
    block as ``coef^(i+1) * y_prev_last``."""
    x = x.to(torch.float32)
    T = x.shape[-1]
    nb = max(1, -(-T // block))
    xb = F.pad(x, (0, nb * block - T)).reshape(*x.shape[:-1], nb, block)
    k = torch.arange(block, dtype=torch.float64, device=x.device)
    expo = k[:, None] - k[None, :]
    toeplitz = torch.where(expo >= 0, coef ** expo.clamp(min=0),
                           torch.zeros_like(expo)).to(torch.float32)
    y = xb @ toeplitz.T
    if nb > 1:
        last = inv_preemphasis(y[..., -1], coef ** block, block)
        prev = F.pad(last[..., :-1], (1, 0))
        y = y + prev[..., None] * (coef ** (k + 1)).to(torch.float32)
    return y.reshape(*x.shape[:-1], nb * block)[..., :T]


def find_endpoint(wav: np.ndarray, cfg: Config, threshold_db: float = -40.0,
                  min_silence_sec: float = 0.8) -> int:
    """Host-side: sample index where a ``min_silence_sec`` window first
    stays below ``threshold_db`` (plus a quarter window), else the length."""
    window_length = int(cfg.sample_rate * min_silence_sec)
    hop = window_length // 4
    threshold = 10.0 ** (threshold_db * 0.05)
    wav = np.asarray(wav)
    for x in range(hop, len(wav) - window_length, hop):
        if np.max(wav[x: x + window_length]) < threshold:
            return x + hop
    return len(wav)
