"""Spectrogram and alignment images as PNG files, written with the
standard library.

The port's counterpart of ``plot_specgram`` and ``plot_alignment`` in
``nspeech_tpu/utils/plot.py``, which draws with matplotlib (not a
dependency of the port). Same file names and content, drawn otherwise:
one 8-bit grayscale pixel per (frame, bin) or (decoder step, input
symbol), frames left to right, the lowest bin or first symbol at the
bottom, values min-max scaled to 0..255 (a constant array is black).
There are no axes, title, caption or colour bar, so the pixels differ
from matplotlib's. The waveform plot (``plot_wave``) is not ported.
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


def plot_alignment(alignment: np.ndarray, path: str, info: str = None) -> None:
    """alignment: [T_in, T_dec]. ``info`` (the JAX package's caption) is
    not drawn."""
    del info
    with open(path, "wb") as f:
        f.write(png_gray8(specgram_image(np.asarray(alignment).T)))
