"""Profiling hooks: port of ``nspeech_tpu/utils/profiling.py``.

- ``trace(log_dir)``: a ``torch.profiler`` capture (the host, and the
  card when there is one) around a code region, written as a gzipped
  Chrome trace (``<log_dir>/<time>.trace.json.gz``, viewable in Perfetto
  or ``chrome://tracing``).
- ``StepTimer``: wall-clock step timing that synchronizes the card on a
  CUDA result, so that a time measures the device's work.
- ``device_memory_stats()``: ``torch.cuda.memory_stats`` per card.
- ``summarize_trace`` / ``print_trace_summary``: per-operation totals of
  a captured trace as ``(total ms, count, name)`` rows, as the JAX
  package's, also as ``python -m nspeech_tpu_torch.utils.profiling DIR
  [TOP]``.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from typing import Optional

import torch

from nspeech_tpu_torch.utils.tree import tree_leaves

# the trace's device rows: kernels and the card's copies and fills
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: Optional[str], record_shapes: bool = False):
    """Profile the block; yields the ``torch.profiler.profile`` object
    (recording each operation's input shapes with ``record_shapes``).
    The Chrome trace goes to ``log_dir``; None writes no file (a caller
    that reads ``key_averages()`` alone)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=record_shapes) as prof:
        yield prof
    if log_dir is None:
        return
    os.makedirs(log_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S") + "-%d" % os.getpid()
    raw = os.path.join(log_dir, stamp + ".trace.json")
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src, gzip.open(raw + ".gz", "wb") as dst:
        dst.write(src.read())
    os.remove(raw)


class StepTimer:
    """Per-step wall time, synchronizing on a result tree."""

    def __init__(self):
        self._start: Optional[float] = None
        self.history: list = []

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None and any(
                isinstance(x, torch.Tensor) and x.is_cuda
                for x in tree_leaves(result)):
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._start
        self.history.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.history) / max(1, len(self.history))


def device_memory_stats() -> dict:
    """``{"cuda:<i>": torch.cuda.memory_stats(i)}`` per card; ``{"cpu":
    None}`` without one (the host's allocator keeps no statistics)."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def summarize_trace(trace_dir: str, top: int = 25):
    """Aggregate the newest trace of ``trace(trace_dir)`` into per-operation
    totals: a list of ``(total_ms, count, name)``, largest first. The rows
    are the card's (kernels, copies, fills) when the trace has any, else
    the host's operators (a CPU run); Python-level rows are dropped."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.trace.json.gz")),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace json under {trace_dir}")
    with gzip.open(paths[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    wanted = DEVICE_CATEGORIES
    if not any(e.get("cat") in wanted for e in events):
        wanted = ("cpu_op",)
    totals: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    for e in events:
        if e.get("cat") in wanted:
            totals[e["name"]] += float(e["dur"])
            counts[e["name"]] += 1
    return [(us / 1000.0, counts[name], name)
            for name, us in totals.most_common(top)]


def print_trace_summary(trace_dir: str, top: int = 25) -> None:
    for ms, n, name in summarize_trace(trace_dir, top):
        print(f"{ms:9.2f} ms  x{n:6d}  {name}")


if __name__ == "__main__":  # python -m nspeech_tpu_torch.utils.profiling <dir>
    import sys

    print_trace_summary(sys.argv[1],
                        int(sys.argv[2]) if len(sys.argv) > 2 else 25)
