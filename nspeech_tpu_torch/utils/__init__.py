"""Utilities: run logging, metric files, spectrogram and alignment images,
parameter trees, the run's git stamp."""

from __future__ import annotations

import subprocess
from collections import deque
from datetime import datetime

from nspeech_tpu_torch.utils.infolog import log


class ValueWindow:
    """Running mean over the most recent ``size`` appended values (the
    training log's step time and loss)."""

    def __init__(self, size: int = 100):
        self._buf: deque = deque(maxlen=size)

    def append(self, value) -> None:
        self._buf.append(value)

    def reset(self) -> None:
        self._buf.clear()

    @property
    def count(self) -> int:
        return len(self._buf)

    @property
    def sum(self):
        return sum(self._buf)

    @property
    def average(self) -> float:
        return sum(self._buf) / len(self._buf) if self._buf else 0.0


def get_git_commit(require_clean: bool = True) -> str:
    """Short hash of HEAD of the working directory's repository, logged
    for stamping a run; refuses a dirty tree by default (a copy of the JAX
    package's helper). A stamp that does not match the code that ran is
    worse than none."""
    dirty = subprocess.run(
        ["git", "diff-index", "--quiet", "HEAD"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    ).returncode != 0
    if dirty and require_clean:
        raise RuntimeError(
            "working tree has uncommitted changes; commit (or pass "
            "--git=False) before stamping a training run")
    head = subprocess.run(
        ["git", "rev-parse", "--short=10", "HEAD"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"git commit: {head}" + (" (dirty tree)" if dirty else ""))
    return head


def time_string() -> str:
    """Local wall-clock timestamp for artifact annotations."""
    return datetime.now().isoformat(sep=" ", timespec="seconds")
