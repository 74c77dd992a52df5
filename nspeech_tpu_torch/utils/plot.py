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

Curves (``plot_curves``, the report tools' counterpart of their
matplotlib line plots) are an RGB image: one coloured polyline per
series on white inside a black frame with five ticks per axis. Text is
not drawn: the axis names, each series' label and colour, and the data
ranges go into the file's ``tEXt`` chunks (``Title``, ``Comment``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png(image: np.ndarray, colour_type: int, text: dict = None) -> bytes:
    """[H, W] (grayscale, type 0) or [H, W, 3] (RGB, type 2) uint8 -> the
    bytes of an 8-bit PNG, with ``text`` (keyword -> Latin-1 string) as
    ``tEXt`` chunks."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),             # filter 0
                           image.reshape(h, image[0:1].size)], axis=1)
    chunks = [_chunk(b"tEXt", k.encode("latin-1") + b"\0"
                     + v.encode("latin-1", "replace"))
              for k, v in (text or {}).items()]
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0))
            + b"".join(chunks)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def png_gray8(image: np.ndarray) -> bytes:
    """[H, W] uint8 -> the bytes of an 8-bit grayscale PNG."""
    return _png(image, 0)


def png_rgb8(image: np.ndarray, text: dict = None) -> bytes:
    """[H, W, 3] uint8 -> the bytes of an 8-bit RGB PNG, with ``text``
    (keyword -> Latin-1 string) as ``tEXt`` chunks."""
    return _png(image, 2, text)


# matplotlib's default cycle, so a curve keeps the colour it had there
PALETTE = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
           (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127))


def curves_image(series, width: int = 770, height: int = 352,
                 margin: int = 24) -> np.ndarray:
    """``series``: [(label, xs, ys)] -> [height, width, 3] uint8 image of
    their polylines, series i in ``PALETTE[i % 8]``, on one pair of
    linear axes spanning every finite point (a range of zero widened by
    one). Non-finite points break a line."""
    image = np.full((height, width, 3), 255, np.uint8)
    x0, y0, x1, y1 = margin, margin, width - 1 - margin, height - 1 - margin
    pts = [(np.asarray(xs, np.float64), np.asarray(ys, np.float64))
           for _, xs, ys in series]
    finite = [(x[np.isfinite(x) & np.isfinite(y)], y[np.isfinite(x) & np.isfinite(y)])
              for x, y in pts]
    allx = np.concatenate([x for x, _ in finite] + [np.zeros(0)])
    ally = np.concatenate([y for _, y in finite] + [np.zeros(0)])
    if allx.size:
        xlo, xhi, ylo, yhi = allx.min(), allx.max(), ally.min(), ally.max()
    else:
        xlo = ylo = 0.0
        xhi = yhi = 1.0
    xhi, yhi = (xhi if xhi > xlo else xlo + 1.0), (yhi if yhi > ylo else ylo + 1.0)

    def to_px(x, y):
        return (x0 + (x - xlo) / (xhi - xlo) * (x1 - x0),
                y1 - (y - ylo) / (yhi - ylo) * (y1 - y0))

    for i, (x, y) in enumerate(pts):
        colour = PALETTE[i % len(PALETTE)]
        px, py = to_px(x, y)
        ok = np.isfinite(px) & np.isfinite(py)
        if ok.sum() == 1:
            image[int(round(py[ok][0])), int(round(px[ok][0]))] = colour
        for j in range(len(x) - 1):
            if not (ok[j] and ok[j + 1]):
                continue
            n = int(max(abs(px[j + 1] - px[j]), abs(py[j + 1] - py[j]))) + 2
            cols = np.round(np.linspace(px[j], px[j + 1], n)).astype(np.int64)
            rows = np.round(np.linspace(py[j], py[j + 1], n)).astype(np.int64)
            image[rows, cols] = colour
    # the frame and five ticks per axis
    image[y0, x0:x1 + 1] = image[y1, x0:x1 + 1] = 0
    image[y0:y1 + 1, x0] = image[y0:y1 + 1, x1] = 0
    for t in np.linspace(0.0, 1.0, 5):
        cx = int(round(x0 + t * (x1 - x0)))
        cy = int(round(y1 - t * (y1 - y0)))
        image[y1:y1 + 5, cx] = 0
        image[cy, x0 - 4:x0 + 1] = 0
    return image


def plot_curves(path: str, series, xlabel: str, ylabel: str) -> None:
    """Line plot of ``series`` ([(label, xs, ys)]; a horizontal reference
    line is a series of two points) as an RGB PNG (:func:`curves_image`).
    The axis names, labels, colours and ranges are in its text chunks."""
    image = curves_image(series)
    ranges = []
    for i, (label, xs, ys) in enumerate(series):
        x = np.asarray(xs, np.float64)
        y = np.asarray(ys, np.float64)
        ok = np.isfinite(x) & np.isfinite(y)
        span = ("x %.6g..%.6g, y %.6g..%.6g" % (x[ok].min(), x[ok].max(),
                                                  y[ok].min(), y[ok].max())
                if ok.any() else "no finite points")
        ranges.append("%s: #%02x%02x%02x, %d points, %s"
                      % ((label,) + PALETTE[i % len(PALETTE)] + (len(x), span)))
    with open(path, "wb") as f:
        f.write(png_rgb8(image, {"Title": "%s against %s" % (ylabel, xlabel),
                                 "Comment": "; ".join(ranges)}))


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
