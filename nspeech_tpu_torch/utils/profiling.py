"""Profiling hooks and the program's span recorder: port of
``nspeech_tpu/utils/profiling.py``, with the spans added.

- ``trace(log_dir)``: a ``torch.profiler`` capture (the host, and the
  card when there is one) around a code region, written as a gzipped
  Chrome trace (``<log_dir>/<time>.trace.json.gz``, viewable in Perfetto
  or ``chrome://tracing``).
- ``span(name, **attrs)`` / ``record(name, t0_ns, t1_ns, **attrs)``:
  the program's spans at its layer boundaries (the batchers, the
  streaming pipeline, the train step, the feeder). They record exactly
  while a ``torch.profiler`` profile runs (``trace`` here, or any other
  caller's); otherwise a span is one global read and a shared no-op
  context. ``spans()`` returns the records, ``clear()`` empties them.
- ``summarize_trace`` / ``print_trace_summary``: per-operation totals of
  a captured trace as ``(total ms, count, name)`` rows, as the JAX
  package's, also as ``python -m nspeech_tpu_torch.utils.profiling DIR
  [TOP]``.

A span's times are ``time.time_ns()``, the clock the profiler reports
its events in, so spans and the device trace's kernels share one
timeline. ``span`` also enters ``record_function("nspeech:" + name)``,
which puts the span in the profile of its thread (``torch.profiler``
records the operations of the thread that started it, and of autograd's
threads under it). A span over asynchronous CUDA work times the host's
part, dispatch and Python, not the card's, unless it closes at a read
that waits for the card.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _torch_profiler

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


# -- spans ---------------------------------------------------------------------

SPAN_PREFIX = "nspeech:"    # the spans' names in a profile
MAX_SPANS = 1 << 16         # records kept; the oldest go first


class Span(NamedTuple):
    """One recorded span. ``parent`` is the id of the span that was open
    on the same thread when this one opened (None at the top);
    ``attrs`` carry the counts at the boundary that a reader needs."""
    name: str
    id: int
    parent: Optional[int]
    thread: str
    t0_ns: int
    t1_ns: int
    attrs: Dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


_records: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(name, span_id, parent, t0_ns, t1_ns, attrs) -> None:
    global _dropped
    rec = Span(name, span_id, parent, threading.current_thread().name,
               t0_ns, t1_ns, attrs)
    with _lock:
        if len(_records) == _records.maxlen:
            _dropped += 1
        _records.append(rec)


class _Off:
    """The span outside a profile: one shared object, no state."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _On:
    """A span inside a profile: its own ``record_function`` beside the
    record, which is kept when it closes while the profile still runs."""
    __slots__ = ("name", "attrs", "id", "parent", "t0_ns", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.t0_ns = time.time_ns()
        self._rf = _torch_profiler.record_function(SPAN_PREFIX + self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        t1_ns = time.time_ns()
        self._rf.__exit__(*exc)
        _stack().pop()
        if _torch_profiler._is_profiler_enabled:
            _keep(self.name, self.id, self.parent, self.t0_ns, t1_ns, self.attrs)
        return False


def span(name: str, **attrs):
    """A context manager that records the block as span ``name`` while a
    profile runs. Outside a profile it records nothing and costs one
    global read."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, attrs)


def stamp() -> Optional[int]:
    """``time.time_ns()`` while a profile runs, else None: the start of a
    span that :func:`record` closes later, on this or another thread."""
    return time.time_ns() if _torch_profiler._is_profiler_enabled else None


def record(name: str, t0_ns: Optional[int], t1_ns: int, **attrs) -> None:
    """Record a span that opened at ``t0_ns`` (a :func:`stamp`, perhaps
    on another thread) and closes at ``t1_ns``, under the span open on
    the calling thread. Nothing is kept outside a profile or without a
    start. Such a span has no event of its own in the profile."""
    if t0_ns is None or not _torch_profiler._is_profiler_enabled:
        return
    stack = _stack()
    _keep(name, next(_ids), stack[-1] if stack else None, t0_ns, t1_ns, attrs)


def spans(name: Optional[str] = None) -> List[Span]:
    """The kept records in the order they closed (of ``name`` alone when
    given)."""
    with _lock:
        out = list(_records)
    return out if name is None else [r for r in out if r.name == name]


def dropped() -> int:
    """Records pushed out of the full buffer since the last clear."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


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
