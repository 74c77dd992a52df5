"""WAV file I/O with resampling: a copy of ``nspeech_tpu/dsp/wavio.py``.

Reads PCM/float WAV with scipy, mixes to mono, converts to float32 in
[-1, 1] and polyphase-resamples to the configured sample rate; FLAC goes
to :mod:`nspeech_tpu_torch.dsp.flacio`.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, sample_rate: int) -> np.ndarray:
    """Load a wav/flac as mono float32 in [-1, 1] at ``sample_rate``.

    Dispatch is on magic bytes: FLAC streams (LibriSpeech corpora) go
    through the pure-Python decoder in nspeech_tpu_torch.dsp.flacio."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        from nspeech_tpu_torch.dsp.flacio import load_flac

        return load_flac(path, sample_rate)
    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if sr != sample_rate:
        ratio = Fraction(sample_rate, sr).limit_denominator(1000)
        wav = resample_poly(wav, ratio.numerator, ratio.denominator).astype(np.float32)
    return wav


def save_wav(wav: np.ndarray, path: str, sample_rate: int) -> None:
    """Peak-normalize to int16 full scale and write (reference: audio.py:17-19)."""
    wav = np.asarray(wav, dtype=np.float32)
    wav = wav * (32767.0 / max(0.01, float(np.max(np.abs(wav)))))
    wavfile.write(path, sample_rate, wav.astype(np.int16))


def load_spectrogram(path: str):
    """(spectrogram, n_frames) from .npy (reference: audio.py:22-24)."""
    spec = np.load(path)
    return spec, spec.shape[0]


def save_spectrogram(spec: np.ndarray, path: str) -> None:
    np.save(path, np.asarray(spec), allow_pickle=False)


def encode_wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """Encode a waveform as in-memory RIFF/WAV bytes (for HTTP serving)."""
    import io

    buf = io.BytesIO()
    wav = np.asarray(wav, dtype=np.float32)
    wav = wav * (32767.0 / max(0.01, float(np.max(np.abs(wav)))))
    wavfile.write(buf, sample_rate, wav.astype(np.int16))
    return buf.getvalue()


def wav_stream_header(sample_rate: int, channels: int = 1,
                      bits: int = 16) -> bytes:
    """RIFF/WAV header with UNKNOWN (maximal) chunk sizes, for chunked
    HTTP streaming where the total length is not known when the first
    bytes leave. Players treat 0xFFFFFFFF as "read until EOF"."""
    import struct

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels,
                                    sample_rate, byte_rate, block_align,
                                    bits)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def encode_pcm16(wav: np.ndarray) -> bytes:
    """float [-1, 1] -> little-endian int16 PCM bytes at FIXED gain (no
    per-utterance normalization — streaming chunks must share one
    scale; mu-law decoded audio is already in [-1, 1])."""
    x = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    return (x * 32767.0).astype("<i2").tobytes()
