"""The host audio loader: ``csrc/loader.cpp`` built with ``g++`` and
bound with ``ctypes``. Port of ``nspeech_tpu/native``.

:func:`load_wav` decodes WAV (PCM 8/16/24/32, float32) and FLAC (by the
file's magic bytes), mixes to mono and resamples with the loader's Kaiser
polyphase filter; :func:`rms_frames` is the center-padded framewise RMS.
The featurizer (``data/features.py``), the window feeder
(``data/wavenet_feeder.py``) and the GTA export (``data/gta.py``) read
audio through it, where the JAX package calls its own native loader.

The library is built at first use (never at import) into ``build/``
beside the package (a directory the repository ignores), named by a
hash of the source, so an edited source is rebuilt; concurrent builds
(test workers, feeder processes) each write a temporary file and rename
it into place. A failed build raises with the compiler's message: unlike
the JAX package, which falls back to its scipy and Python decoders,
there is no fallback. ``dsp/wavio.py`` and ``dsp/flacio.py`` stay as the
plain versions the loader is tested against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_LOCK = threading.Lock()
_ERR_LEN = 1024
_f32p = ctypes.POINTER(ctypes.c_float)


def build() -> ctypes.CDLL:
    """Compile ``csrc/loader.cpp`` (once per process and source hash) and
    return the bound library. Raises ``RuntimeError`` when ``g++`` is
    missing or fails."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(_compile())))
    return _LIB


def _compile() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + repr(GXX_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"loader-{digest}.so"
    if lib_path.exists():
        return lib_path
    gxx = os.environ.get("CXX") or shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's audio loader "
                           f"({SOURCE}) is built with a C++ compiler")
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.nst_load_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_f32p), i64p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.nst_load_wav.restype = ctypes.c_int
    lib.nst_rms_frames.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_f32p), i64p, ctypes.c_char_p, ctypes.c_int]
    lib.nst_rms_frames.restype = ctypes.c_int
    lib.nst_free.argtypes = [_f32p]
    lib.nst_free.restype = None
    return lib


def _take(lib, buf, n: int) -> np.ndarray:
    """Copy a library buffer of ``n`` floats into numpy and free it."""
    try:
        return np.ctypeslib.as_array(buf, shape=(n,)).copy() if n else (
            np.zeros(0, np.float32))
    finally:
        lib.nst_free(buf)


def load_wav(path: str, sample_rate: int) -> np.ndarray:
    """Mono float32 waveform in [-1, 1] at ``sample_rate``. Raises
    ``IOError`` (``OSError``) for a file the loader cannot decode, and the
    ``OSError`` of its errno (``FileNotFoundError`` for a missing file) for
    one it cannot open."""
    lib = build()
    buf, n, sr = _f32p(), ctypes.c_int64(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.nst_load_wav(os.fsencode(path), int(sample_rate), ctypes.byref(buf),
                          ctypes.byref(n), ctypes.byref(sr), err, _ERR_LEN)
    if rc > 0:
        raise OSError(rc, os.strerror(rc), path)
    if rc != 0:
        raise IOError(err.value.decode(errors="replace"))
    return _take(lib, buf, n.value)


def rms_frames(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Center-padded framewise RMS of ``x`` (float32), librosa's
    ``feature.rms`` convention."""
    lib = build()
    x = np.ascontiguousarray(x, np.float32)
    buf, n = _f32p(), ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.nst_rms_frames(x.ctypes.data_as(_f32p), x.size, int(frame_length),
                          int(hop_length), ctypes.byref(buf), ctypes.byref(n),
                          err, _ERR_LEN) != 0:
        raise ValueError(err.value.decode(errors="replace"))
    return _take(lib, buf, n.value)
