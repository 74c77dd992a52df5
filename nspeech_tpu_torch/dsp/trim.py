"""Silence trimming (host-side numpy): a copy of ``nspeech_tpu/dsp/trim.py``.

Behavioral rebuild of the reference's librosa-based trimming
(reference: neural_speech/datasets/process.py:39-68): interval splitting by
relative dB level (librosa.effects.split semantics) and RMS-energy trimming
(librosa.feature.rmse semantics).
"""

from __future__ import annotations

import numpy as np


def _rms_frames(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Center-padded framewise RMS, matching librosa.feature.rms defaults."""
    pad = frame_length // 2
    y = np.pad(y, (pad, pad), mode="constant")
    n = 1 + (len(y) - frame_length) // hop_length
    if n <= 0:
        return np.zeros(0, dtype=np.float32)
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    frames = y[idx]
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1))


def split_nonsilent(
    y: np.ndarray, top_db: float = 25.0, frame_length: int = 1024,
    hop_length: int = 512,
) -> np.ndarray:
    """Intervals [start, end) (in samples) louder than max - top_db dB.

    Same contract as librosa.effects.split.
    """
    rms = _rms_frames(y, frame_length, hop_length)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(np.max(rms), 1e-10))
    non_silent = db > -top_db
    intervals = []
    in_run = bool(non_silent[0]) if len(non_silent) else False
    start = 0
    for i in range(1, len(non_silent)):
        if non_silent[i] and not in_run:
            start, in_run = i, True
        elif not non_silent[i] and in_run:
            intervals.append((start, i))
            in_run = False
    if in_run:
        intervals.append((start, len(non_silent)))
    return np.array(
        [(s * hop_length, min(e * hop_length, len(y))) for s, e in intervals],
        dtype=np.int64,
    ).reshape(-1, 2)


def trim_wav(wav: np.ndarray, threshold_db: float = 25.0) -> np.ndarray:
    """Trim leading/trailing silence, keeping a 2000-sample margin around the
    first/last interval longer than 2000 samples
    (reference: process.py:39-42,57-68)."""
    splits = split_nonsilent(wav, top_db=threshold_db, frame_length=1024, hop_length=512)
    return wav[_find_start(splits): _find_end(splits, len(wav))]


def trim_silence(wav: np.ndarray, threshold: float, frame_length: int = 2048) -> np.ndarray:
    """Trim by absolute RMS threshold (reference: process.py:45-54). Returns
    an empty array when the whole signal is silence."""
    if wav.size < frame_length:
        frame_length = max(int(wav.size), 1)
    energy = _rms_frames(wav, frame_length, hop_length=512)
    frames = np.nonzero(energy > threshold)[0]
    if frames.size == 0:
        return wav[:0]
    start = int(frames[0]) * 512
    end = int(frames[-1]) * 512
    return wav[start:end]


def _find_start(splits: np.ndarray, min_samples: int = 2000) -> int:
    for split_start, split_end in splits:
        if split_end - split_start > min_samples:
            return max(0, int(split_start) - min_samples)
    return 0


def _find_end(splits: np.ndarray, num_samples: int, min_samples: int = 2000) -> int:
    for split_start, split_end in splits[::-1]:
        if split_end - split_start > min_samples:
            return min(num_samples, int(split_end) + min_samples)
    return num_samples
