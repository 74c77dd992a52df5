"""Utilities: run logging, metric files, spectrogram and alignment images,
parameter trees."""

from __future__ import annotations

from collections import deque
from datetime import datetime


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
    def average(self) -> float:
        return sum(self._buf) / len(self._buf) if self._buf else 0.0


def time_string() -> str:
    """Local wall-clock timestamp for artifact annotations."""
    return datetime.now().isoformat(sep=" ", timespec="seconds")
