"""Plain signal processing of the recipe (``hparams/audio.yaml``).

Featurizing: pre-emphasis, a centred (reflect-padded) STFT with a
periodic Hann window of ``frame_length_ms`` zero-padded to ``n_fft``,
magnitudes in dB against 1e-5, the linear spectrogram less
``ref_level_db``, the mel spectrogram through a Slaney mel filterbank,
both normalised by ``min_level_db`` into [0, 1].

Synthesis: Griffin-Lim from an initial phase, through ``torch.stft`` and
``torch.istft`` (the served path writes its own overlap-add), inverse
pre-emphasis by ``scipy.signal.lfilter`` in float64, and the endpoint
(the first 0.8 s window below -40 dB). The initial phase of row i of a
batch of n is JAX's ``uniform(split(PRNGKey(0), n)[i])`` (Threefry-2x32,
partitionable counters): a frozen copy of the draw the served path
makes, since it is part of what a served waveform is.

Mu-law: the decode table of Q levels, and the vocoder's conditioning,
the mel upsampled to samples by linear interpolation with frame t at
sample t * hop (held past the last frame)."""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch


def stft_params(cfg):
    n_fft = (cfg["num_freq"] - 1) * 2
    hop = int(cfg["frame_shift_ms"] / 1000 * cfg["sample_rate"])
    win = int(cfg["frame_length_ms"] / 1000 * cfg["sample_rate"])
    return n_fft, hop, win


def window(n_fft, win, device=None):
    n = np.arange(win)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)
    left = (n_fft - win) // 2
    return torch.from_numpy(np.pad(w, (left, n_fft - win - left)).astype(np.float32)).to(device)


# -- featurizing --------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    m * (200.0 / 3))


def mel_basis(sr, n_fft, n_mels):
    """Slaney-normalised triangular filters [n_mels, 1 + n_fft // 2]."""
    fft_f = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def featurize(wav: np.ndarray, cfg):
    """(linear [T, F], mel [T, M]) float32 of a float waveform."""
    n_fft, hop, win = stft_params(cfg)
    x = np.asarray(wav, np.float32)
    emph = np.concatenate([x[:1], x[1:] - np.float32(cfg["preemphasis"]) * x[:-1]])
    spec = torch.stft(torch.from_numpy(emph.astype(np.float32)), n_fft, hop,
                      window=window(n_fft, win), center=True, pad_mode="reflect",
                      return_complex=True)
    mag = spec.abs().T                                       # [T, F]
    floor = -abs(cfg["min_level_db"])

    def norm(db):
        return torch.clamp((db - floor) / -floor, 0.0, 1.0)

    db = lambda a: 20.0 * torch.log10(torch.clamp(a, min=1e-5))   # noqa: E731
    basis = torch.from_numpy(mel_basis(cfg["sample_rate"], n_fft, cfg["num_mels"]))
    linear = norm(db(mag) - cfg["ref_level_db"])
    mel = norm(db(mag @ basis.T))
    return linear.numpy(), mel.numpy()


# -- synthesis ----------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(key, x0, x1):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rotl = lambda v, r: (v << np.uint32(r)) | (v >> np.uint32(32 - r))   # noqa: E731
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(n):
    j = np.arange(n, dtype=np.uint64)
    return (j >> np.uint64(32)).astype(np.uint32), j.astype(np.uint32)


def initial_phase(n: int, row: int, shape) -> np.ndarray:
    """Row ``row`` of a batch of ``n``: uniform [0, 1) of ``shape``."""
    b0, b1 = _threefry((0, 0), *_counters(n))
    key = (int(b0[row]), int(b1[row]))
    size = int(np.prod(shape))
    c0, c1 = _threefry(key, *_counters(size))
    bits = ((c0 ^ c1) >> np.uint32(9)) | np.uint32(0x3F800000)
    u = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(u, np.float32(0.0)).reshape(shape)


def griffin_lim(linear: torch.Tensor, phase: torch.Tensor, cfg) -> torch.Tensor:
    """Normalised linear spectrogram [T, F] -> waveform [(T - 1) * hop]."""
    n_fft, hop, win = stft_params(cfg)
    w = window(n_fft, win, linear.device)
    floor = -abs(cfg["min_level_db"])
    S = torch.pow(10.0, (torch.clamp(linear, 0.0, 1.0) * -floor + floor
                         + cfg["ref_level_db"]) * 0.05)
    S = torch.pow(S, cfg["power"]).T.to(torch.complex64)        # [F, T]
    length = (linear.shape[0] - 1) * hop

    def istft(spec):
        return torch.istft(spec, n_fft, hop, window=w, center=True, length=length)

    y = istft(S * torch.exp(2j * math.pi * phase.T))
    for _ in range(cfg["griffin_lim_iters"]):
        est = torch.stft(y, n_fft, hop, window=w, center=True, pad_mode="reflect",
                         return_complex=True)
        y = istft(S * (est / torch.clamp(est.abs(), min=1e-8)))
    return y


def inv_preemphasis(x: np.ndarray, coef: float) -> np.ndarray:
    return scipy.signal.lfilter([1.0], [1.0, -coef], np.asarray(x, np.float64)).astype(np.float32)


def find_endpoint(wav: np.ndarray, cfg, threshold_db=-40.0, min_silence_s=0.8) -> int:
    w = int(cfg["sample_rate"] * min_silence_s)
    hop = w // 4
    threshold = 10.0 ** (threshold_db * 0.05)
    for x in range(hop, len(wav) - w, hop):
        if np.max(wav[x:x + w]) < threshold:
            return x + hop
    return len(wav)


def mu_law_table(q: int) -> np.ndarray:
    mu = q - 1
    s = 2.0 * np.arange(q) / mu - 1.0
    return (np.sign(s) * ((1.0 + mu) ** np.abs(s) - 1.0) / mu).astype(np.float32)


def upsample(mel: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    """mel [T, M] -> [length, M]: frame t at sample t * hop, linear in
    between, held past the last frame."""
    pos = torch.arange(length, device=mel.device, dtype=torch.float64) / hop
    i0 = torch.clamp(torch.floor(pos).long(), 0, mel.shape[0] - 1)
    i1 = torch.clamp(i0 + 1, 0, mel.shape[0] - 1)
    w = (pos - i0.double()).clamp(0.0, 1.0)[:, None]
    return (mel[i0].double() * (1.0 - w) + mel[i1].double() * w).float()
