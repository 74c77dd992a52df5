"""Spectrogram and alignment images as PNG files, written with the
standard library.

The port's counterpart of ``plot_specgram`` and ``plot_alignment`` in
``nspeech_tpu/utils/plot.py``, which draws with matplotlib (not a
dependency of the port). Same file names and content, drawn otherwise:
one 8-bit grayscale pixel per (frame, bin) or (decoder step, input
symbol), frames left to right, the lowest bin or first symbol at the
bottom, values min-max scaled to 0..255 (a constant array is black).
There are no axes, title, caption or colour bar, so the pixels differ
from matplotlib's. The waveform (``plot_wave``) is drawn as its envelope:
per pixel column the minimum and maximum of the samples it covers, a
white bar on black, time left to right.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_gray8(image: np.ndarray) -> bytes:
    """[H, W] uint8 -> the bytes of an 8-bit grayscale PNG."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image], axis=1)  # filter 0
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def specgram_image(spec: np.ndarray) -> np.ndarray:
    """[T, F] spectrogram -> [F, T] uint8 image, low bins on the last row."""
    spec = np.asarray(spec, np.float64)
    lo, hi = float(spec.min()), float(spec.max())
    scaled = (spec - lo) / (hi - lo) if hi > lo else np.zeros_like(spec)
    return np.round(scaled.T[::-1] * 255.0).astype(np.uint8)


def plot_specgram(spec: np.ndarray, path: str, spec_type: str = "linear") -> None:
    """spec: [T, F] normalized dB spectrogram (time-major). ``spec_type``
    ("linear" or "mel") names the plot in the JAX package; the image is
    the same for both."""
    del spec_type
    with open(path, "wb") as f:
        f.write(png_gray8(specgram_image(spec)))


def wave_image(wav: np.ndarray, width: int = 1200, height: int = 200) -> np.ndarray:
    """[N] waveform -> [height, width] uint8 envelope image: column c
    spans samples [c*N/width, (c+1)*N/width) and is white from their
    minimum to their maximum, on a [-1, 1] vertical scale with +1 on the
    top row (values outside it are clipped). Fewer samples than ``width``
    give one column per sample; an empty waveform a black image."""
    wav = np.clip(np.asarray(wav, np.float64).reshape(-1), -1.0, 1.0)
    n = len(wav)
    width = max(1, min(width, n))
    image = np.zeros((height, width), np.uint8)
    if n == 0:
        return image
    edges = (np.arange(width + 1) * n) // width
    lo = np.minimum.reduceat(wav, edges[:-1])
    hi = np.maximum.reduceat(wav, edges[:-1])
    # row 0 is +1, row height-1 is -1
    top = np.round((1.0 - hi) * 0.5 * (height - 1)).astype(np.int64)
    bottom = np.round((1.0 - lo) * 0.5 * (height - 1)).astype(np.int64)
    rows = np.arange(height)[:, None]
    image[(rows >= top[None, :]) & (rows <= bottom[None, :])] = 255
    return image


def plot_wave(wav: np.ndarray, sample_rate: int, path: str, text: str = "") -> None:
    """The waveform's envelope as a PNG (:func:`wave_image`).
    ``sample_rate`` and ``text`` (the JAX package's time axis and title)
    are not drawn."""
    del sample_rate, text
    with open(path, "wb") as f:
        f.write(png_gray8(wave_image(wav)))


def plot_alignment(alignment: np.ndarray, path: str, info: str = None) -> None:
    """alignment: [T_in, T_dec]. ``info`` (the JAX package's caption) is
    not drawn."""
    del info
    with open(path, "wb") as f:
        f.write(png_gray8(specgram_image(np.asarray(alignment).T)))
