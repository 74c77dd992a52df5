"""Measurements of synthesized audio and attention, in numpy.

The port's copies of the pure functions of the JAX package's report
scripts, with their arithmetic unchanged: from ``scripts/alignment_report.py``
the sharpness smoothing, ``monotonicity`` and the three voice estimators
(``median_f0``, ``spectral_centroid``, ``spectral_shift_ratio``); from
``scripts/vocoder_report.py`` the tone tracker, ``spectral_cosine``,
``log_spectral_centroid`` and ``mel_l1``, the last on the port's
featurizer (``dsp/audio.py`` ``spectrograms``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def smooth_sharpness(sharp: Sequence[float]) -> Tuple[int, np.ndarray]:
    """``(k, smoothed)``: the moving mean over k = len // 40 summaries (at
    least 1), only where the window fits. The smoothed curve starts at
    summary k - 1."""
    k = max(1, len(sharp) // 40)
    return k, np.convolve(sharp, np.ones(k) / k, mode="valid")


def monotonicity(align: np.ndarray, steps_used: int) -> float:
    """align [T_in, S]; fraction of voiced decoder steps whose argmax
    input position moves forward or stays (tolerating 1-position
    backtrack, which r-frame quantization produces)."""
    path = np.argmax(align[:, :steps_used], axis=0)
    if len(path) < 2:
        return 1.0
    return float(np.mean(np.diff(path) >= -1))


def median_f0(wav: np.ndarray, sample_rate: int, n_fft: int = 2048,
              hop: int = 512, f_min: float = 80.0,
              f_max: float = 3500.0) -> float:
    """Median over voiced frames of a harmonic-product-spectrum F0.

    A plain FFT-argmax lands on whichever partial is loudest, which for
    voices with a harmonic tilt above 1 is the 2nd or 3rd harmonic. The
    HPS multiplies the spectrum with itself decimated by 2 and 3, so only
    the true fundamental keeps support at every harmonic. A frame is
    voiced when its RMS is at least half the utterance's."""
    overall = float(np.sqrt(np.mean(np.square(wav)))) or 1.0
    peaks = []
    lo = max(1, int(f_min * n_fft / sample_rate))
    # cap so every candidate bin has all three harmonic terms available
    hi = min(int(f_max * n_fft / sample_rate), (n_fft // 2 + 1 + 2) // 3)
    for start in range(0, max(len(wav) - n_fft + 1, 1), hop):
        frame = wav[start: start + n_fft]
        if len(frame) < n_fft or float(
                np.sqrt(np.mean(frame ** 2))) < 0.5 * overall:
            continue
        mag = np.abs(np.fft.rfft(frame * np.hanning(len(frame))))
        hps = np.log(mag[:hi] + 1e-9).copy()
        for h in (2, 3):
            dec = mag[::h][:hi]
            hps[:len(dec)] += np.log(dec + 1e-9)
        peaks.append((lo + int(np.argmax(hps[lo:]))) * sample_rate / n_fft)
    return float(np.median(peaks)) if peaks else 0.0


def spectral_centroid(wav: np.ndarray, sample_rate: int,
                      f_lo: float = 80.0, f_hi: float = 4000.0) -> float:
    """Power-weighted mean frequency of the in-band spectrum of the first
    4 s (0 for fewer than 2,048 samples). For two voices that differ by a
    pure frequency scale, centroids scale by the same factor."""
    n = min(len(wav), sample_rate * 4)
    if n < 2048:
        return 0.0
    mag = np.abs(np.fft.rfft(wav[:n] * np.hanning(n)))
    f = np.fft.rfftfreq(n, 1.0 / sample_rate)
    band = (f >= f_lo) & (f <= f_hi)
    w = mag[band] ** 2
    return float((f[band] * w).sum() / (w.sum() + 1e-12))


def spectral_shift_ratio(wav_ref: np.ndarray, wav: np.ndarray,
                         sample_rate: int, f_lo: float = 80.0,
                         f_hi: float = 4000.0) -> float:
    """Frequency scale of ``wav`` relative to ``wav_ref``: the shift that
    best aligns their log-frequency log-spectra (a rigid shift on that
    axis for the same utterance in two voices), from every partial at
    once."""
    n = min(len(wav_ref), len(wav), sample_rate * 4)
    if n < 2048:
        return 0.0
    f = np.fft.rfftfreq(n, 1.0 / sample_rate)
    grid = np.geomspace(f_lo, f_hi, 2048)
    win = np.hanning(n)
    logs = []
    for w in (wav_ref, wav):
        mag = np.abs(np.fft.rfft(w[:n] * win))
        ls = np.log(np.interp(grid, f, mag) + 1e-6)
        logs.append(ls - ls.mean())
    xc = np.correlate(logs[1], logs[0], "full")
    shift = int(np.argmax(xc)) - (len(grid) - 1)
    return float((grid[1] / grid[0]) ** shift)


def dominant_freq_track(wav: np.ndarray, sr: int, frame: int = 1024,
                        hop: int = 256) -> np.ndarray:
    """Per-frame dominant frequency (Hz) via FFT peak: on a corpus built
    from tones the dominant bin is the signal's identity."""
    n = (len(wav) - frame) // hop
    freqs = np.fft.rfftfreq(frame, 1.0 / sr)
    out = np.zeros(max(n, 0), np.float32)
    for i in range(max(n, 0)):
        seg = wav[i * hop: i * hop + frame] * np.hanning(frame)
        mag = np.abs(np.fft.rfft(seg))
        out[i] = freqs[int(np.argmax(mag))]
    return out


def track_agreement(a: np.ndarray, b: np.ndarray, tol_hz: float = 50.0):
    """Fraction of frames whose dominant frequencies agree within tol."""
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    return float(np.mean(np.abs(a[:n] - b[:n]) <= tol_hz))


def spectral_cosine(a: np.ndarray, b: np.ndarray, sr: int,
                    frame: int = 1024, hop: int = 256) -> float:
    """Mean per-frame cosine similarity of log-magnitude spectra, robust
    where harmonics or tremolo make the argmax bin flicker."""
    n = min((len(a) - frame) // hop, (len(b) - frame) // hop)
    sims = []
    for i in range(max(n, 0)):
        w = np.hanning(frame)
        fa = np.log1p(np.abs(np.fft.rfft(a[i * hop: i * hop + frame] * w)))
        fb = np.log1p(np.abs(np.fft.rfft(b[i * hop: i * hop + frame] * w)))
        denom = np.linalg.norm(fa) * np.linalg.norm(fb)
        if denom > 0:
            sims.append(float(fa @ fb / denom))
    return float(np.mean(sims)) if sims else 0.0


def log_spectral_centroid(wav: np.ndarray, sr: int, f_lo: float = 80.0,
                          f_hi: float = 4000.0) -> float:
    """Geometric-mean spectral centroid (Hz) over the 80-4000 Hz band,
    the voice summary of the multi-speaker corpora."""
    x = np.asarray(wav, np.float64)
    f = np.fft.rfftfreq(len(x), 1.0 / sr)
    m = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    band = (f > f_lo) & (f < f_hi)
    if not band.any() or m[band].sum() <= 0:
        return 0.0
    return float(np.exp((np.log(f[band]) * m[band]).sum() / m[band].sum()))


def mel_l1(wav: np.ndarray, ref_mel: np.ndarray, cfg) -> float:
    """L1 between the mel of ``wav`` and ``ref_mel`` (both [T, M] in the
    normalized [0, 1] mel domain), over the overlap."""
    from nspeech_tpu_torch.dsp.audio import spectrograms

    _, mel = spectrograms(np.asarray(wav, np.float32), cfg)
    t = min(len(mel), len(ref_mel))
    return float(np.mean(np.abs(mel[:t] - np.asarray(ref_mel)[:t])))
