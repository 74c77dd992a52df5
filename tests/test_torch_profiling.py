"""The port's profiling hooks (``utils/profiling.py``) and waveform plot
(``utils/plot.py`` ``plot_wave``), on the CPU.

- ``trace`` writes a gzipped Chrome trace of the block that
  ``summarize_trace`` reads back as ``(ms, count, name)`` rows (the host's
  operators on a CPU run), also through ``python -m``. The span recorder
  is tested in ``tests/test_torch_tracing.py``.
- ``plot_wave`` writes a valid 8-bit grayscale PNG whose pixels are the
  waveform's per-column min/max envelope.
"""

import gzip
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import torch

from nspeech_tpu_torch.utils import plot, profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_is_summarized(tmp_path):
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, 32)).astype(np.float32))
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(3):
            b = torch.relu(a @ a)
    assert prof is not None and b.shape == (32, 32)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".trace.json.gz")]
    assert len(files) == 1
    with gzip.open(tmp_path / files[0]) as f:
        assert json.load(f)["traceEvents"]
    rows = profiling.summarize_trace(str(tmp_path), top=50)
    names = {name: (ms, n) for ms, n, name in rows}
    assert names["aten::mm"][1] == 3 and names["aten::relu"][1] == 3
    assert all(ms >= 0 for ms, _, _ in rows)
    assert rows == sorted(rows, key=lambda r: -r[0])
    out = subprocess.run([sys.executable, "-m", "nspeech_tpu_torch.utils.profiling",
                          str(tmp_path), "5"], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert len(out.strip().splitlines()) == 5 and " ms  x" in out


def test_missing_trace_raises(tmp_path):
    import pytest

    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path))


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n: pos + 12 + n])[0]
        assert zlib.crc32(kind + body) & 0xFFFFFFFF == crc
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 0)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, w + 1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:]


def test_plot_wave_writes_the_envelope(tmp_path):
    sr = 20000
    t = np.arange(sr) / sr
    wav = (0.5 * np.sin(2 * np.pi * 3 * t) * (t < 0.5)).astype(np.float32)
    path = str(tmp_path / "w.png")
    plot.plot_wave(wav, sr, path, "some text")
    image = _read_png(path)
    assert image.shape == (200, 1200)
    assert set(np.unique(image)) <= {0, 255}
    # the first half swings to +-0.5 (rows ~50 to ~149), the silent half
    # is one row at 0
    lit = [np.flatnonzero(col) for col in image.T]
    assert min(c.min() for c in lit[:600]) in range(48, 52)
    assert max(c.max() for c in lit[:600]) in range(148, 152)
    assert all(len(c) == 1 and c[0] in (99, 100) for c in lit[620:])
    plot.plot_wave(np.zeros(0, np.float32), sr, path)
    assert _read_png(path).shape == (200, 1)
