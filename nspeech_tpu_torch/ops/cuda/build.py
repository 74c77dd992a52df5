"""Build a CUDA source of ``csrc/`` into a shared library and load it.

``nvcc`` compiles the file into ``build/`` beside the package (a
directory the repository ignores) at first use, named by a hash of the
source and of its defines, so an edited source is rebuilt and a build
with defines (``-DWAVENET_STAMPS``) sits beside the normal one. The
library has a plain C interface and is bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[Tuple[str, Tuple[str, ...]], Tuple[ctypes.CDLL, str]] = {}
# a server's worker threads (the batchers) may reach their first launch
# together: one of them builds, the others wait for its library
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build on a machine with the CUDA toolkit")
    return found


def build(source: str, defines: Tuple[str, ...] = ()) -> Tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<source>`` with ``-D<name>`` for each of ``defines``
    (once per process, source hash and defines) and return ``(library,
    ptxas report)``."""
    key = (source, tuple(defines))
    with _LOCK:
        if key not in _LOADED:
            _LOADED[key] = _compile(source, key[1])
    return _LOADED[key]


def _compile(source: str, defines: Tuple[str, ...]) -> Tuple[ctypes.CDLL, str]:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + repr(defines).encode()
                            ).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"{src.stem}-{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if not lib_path.exists():
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
        proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        log_path.write_text(proc.stderr)
        os.replace(tmp, lib_path)
    report = log_path.read_text() if log_path.exists() else ""
    return ctypes.CDLL(str(lib_path)), report
