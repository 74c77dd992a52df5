"""Dynamic request batching for serving.

Port of ``nspeech_tpu/serving/batcher.py``. Requests that arrive together
should share one padded forward and one sampler launch (one 8-CTA cluster
per stream on the card, so a batch of a few streams costs about one
stream's time). :class:`DynamicBatcher` wraps anything with
``synthesize_batch(texts, speaker_ids) -> (wavs, mels, lins)`` (a
``Synthesizer`` or ``TextToSpeech``) behind the single-request
``synthesize`` contract; :class:`StreamBatcher` does the same for
``StreamingTTS.stream_batch``.

Each has one worker thread: it takes the first request, waits
``window_ms`` for companions (up to ``max_batch``), runs one batched call
and fans the results out. One worker is deliberate: the card runs the
launches of one CUDA stream in order anyway, so more batches in flight
would only queue.

While a profile runs (``utils/profiling.py``) each group records
``batcher.group`` around its call, with its rows and the requests still
queued at dispatch, and under it each of its requests ``batcher.wait``,
from the request's enqueue to the start of the call.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, NamedTuple, Optional

from nspeech_tpu_torch.utils import profiling


class _Request(NamedTuple):
    text: str
    speaker_id: Any
    sink: Any                 # the caller's Future (one-shot) or chunk queue
    t_enq: Optional[int]      # enqueue time (profiling.stamp), None untraced


def _is_default(speaker_id) -> bool:
    return speaker_id is None or speaker_id < 0


def _gather(q: queue.Queue, max_batch: int, window: float):
    """Block for a first item, then take more for ``window`` seconds (up
    to ``max_batch``). Returns (batch, stop): ``stop`` when the close
    sentinel (None) arrived; the batch is then what came before it."""
    head = q.get()
    if head is None:
        return [], True
    batch = [head]
    deadline = time.monotonic() + window
    while len(batch) < max_batch:
        try:
            item = q.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            break
        if item is None:
            return batch, True
        batch.append(item)
    return batch, False


def _partition(batch):
    """Default (-1/None) and explicit speakers cannot share one batch
    (``synthesize_batch`` and ``stream_batch`` refuse the mix):
    independent requests may disagree, so split them."""
    default = [b for b in batch if _is_default(b[1])]
    explicit = [b for b in batch if not _is_default(b[1])]
    return [g for g in (default, explicit) if g]


@contextlib.contextmanager
def _group_span(q: queue.Queue, group):
    """The group's ``batcher.group`` span, with each request's
    ``batcher.wait`` (enqueue to now) under it; nothing outside a
    profile."""
    now = profiling.stamp()
    if now is None:
        yield
        return
    with profiling.span("batcher.group", rows=len(group), queued=q.qsize()):
        for r in group:
            profiling.record("batcher.wait", r.t_enq, now)
        yield


class _Batcher:
    """The worker both batchers share: one thread takes a window of
    requests (:func:`_gather`), splits it (:func:`_partition`) and hands
    each group to the subclass's ``_dispatch_group`` under its spans."""

    def __init__(self, max_batch: int, window_ms: float, name: str):
        self.max_batch = max(1, int(max_batch))
        self.window = max(0.0, float(window_ms)) / 1000.0
        self._q: queue.Queue = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0}
        self._worker = threading.Thread(target=self._run, daemon=True, name=name)
        self._worker.start()

    def _enqueue(self, text: str, speaker_id, sink) -> None:
        if not self._worker.is_alive():
            raise RuntimeError(f"{type(self).__name__} worker thread is dead")
        self._q.put(_Request(text, speaker_id, sink, profiling.stamp()))

    def _run(self) -> None:
        while True:
            batch, stop = _gather(self._q, self.max_batch, self.window)
            for group in _partition(batch):
                with _group_span(self._q, group):
                    self._dispatch_group(group)
            if stop:
                return

    def _count(self, group) -> None:
        self.stats["requests"] += len(group)
        self.stats["batches"] += 1
        self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(group))


class DynamicBatcher(_Batcher):
    def __init__(self, synthesizer, max_batch: int = 8,
                 window_ms: float = 10.0):
        if not hasattr(synthesizer, "synthesize_batch"):
            raise ValueError("synthesizer has no synthesize_batch")
        self._synth = synthesizer
        super().__init__(max_batch, window_ms, "dynamic-batcher")

    # --- single-request surface (what the demo server's routes call) ------

    def synthesize(self, text: str, speaker_id: int = -1,
                   timeout: Optional[float] = 600.0):
        """Enqueue and wait; returns (wav, mel, lin) like ``Synthesizer``.
        The timeout keeps a dead worker from blocking callers forever."""
        fut: Future = Future()
        self._enqueue(text, speaker_id, fut)
        return fut.result(timeout=timeout)

    def synthesize_batch(self, texts, speaker_ids=None):
        # a caller's batch is already a batch: passed through, outside the
        # window's accounting
        return self._synth.synthesize_batch(texts, speaker_ids)

    @property
    def cfg(self):
        return getattr(self._synth, "cfg", None)

    def close(self) -> None:
        self._q.put(None)
        self._worker.join(timeout=5.0)

    def _dispatch_group(self, batch, _retry: bool = False) -> None:
        texts = [r.text for r in batch]
        speakers = [r.speaker_id for r in batch]
        if not _retry:
            # a failed window re-runs its items one by one; counting the
            # retries would book every window-mate twice in /stats
            self._count(batch)
        try:
            wavs, mels, lins = self._synth.synthesize_batch(texts, speakers)
        except Exception as e:
            if len(batch) > 1:
                # one bad request (a ClientError, say) fails alone
                for item in batch:
                    self._dispatch_group([item], _retry=True)
                return
            for r in batch:
                if not r.sink.cancelled():
                    r.sink.set_exception(e)
            return
        for i, r in enumerate(batch):
            if not r.sink.cancelled():
                r.sink.set_result((wavs[i], mels[i], lins[i]))


_STREAM_END = object()


class StreamBatcher(_Batcher):
    """Dynamic batching for streaming requests.

    Wraps a ``StreamingTTS``: concurrent callers iterate :meth:`stream`;
    the worker groups the requests that arrive within ``window_ms`` of the
    first (up to ``max_batch``) and drives one ``stream_batch`` for the
    group, one carried sampler launch per chunk for all of its streams.
    Chunks go to each caller's queue as the batched pipeline yields them.

    While a group streams, new arrivals wait for the next window: the
    group's launches keep the card busy back to back. A failure mid-stream
    aborts the whole group: its callers have partial audio already, so a
    per-item retry cannot apply.
    """

    def __init__(self, streamer, max_batch: int = 8,
                 window_ms: float = 20.0):
        if not hasattr(streamer, "stream_batch"):
            raise ValueError("streamer has no stream_batch")
        self._tts = streamer
        super().__init__(max_batch, window_ms, "stream-batcher")

    def stream(self, text: str, speaker_id: int = -1,
               timeout: Optional[float] = 600.0):
        """Enqueue and yield waveform chunks as the batched pipeline makes
        them. ``timeout`` bounds the wait for each chunk."""
        out: queue.Queue = queue.Queue()
        self._enqueue(text, speaker_id, out)
        while True:
            try:
                item = out.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    "StreamBatcher: no chunk within %.0f s. A cold first "
                    "request builds the sampler (nvcc) and plans cuDNN "
                    "for the window shapes; warm streams deliver a chunk "
                    "per launch" % (timeout or 0)) from None
            if item is _STREAM_END:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self) -> None:
        self._q.put(None)

    def _dispatch_group(self, batch) -> None:
        texts = [r.text for r in batch]
        speakers = [r.speaker_id for r in batch]
        queues = [r.sink for r in batch]
        self._count(batch)
        try:
            for chunks in self._tts.stream_batch(texts, speakers):
                for q, c in zip(queues, chunks):
                    if c is not None and len(c):
                        q.put(c)
        except Exception as e:
            for q in queues:
                q.put(e)
            return
        for q in queues:
            q.put(_STREAM_END)
