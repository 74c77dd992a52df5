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
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional


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


class DynamicBatcher:
    def __init__(self, synthesizer, max_batch: int = 8,
                 window_ms: float = 10.0):
        if not hasattr(synthesizer, "synthesize_batch"):
            raise ValueError("synthesizer has no synthesize_batch")
        self._synth = synthesizer
        self.max_batch = max(1, int(max_batch))
        self.window = max(0.0, float(window_ms)) / 1000.0
        self._q: queue.Queue = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="dynamic-batcher")
        self._worker.start()

    # --- single-request surface (what the demo server's routes call) ------

    def synthesize(self, text: str, speaker_id: int = -1,
                   timeout: Optional[float] = 600.0):
        """Enqueue and wait; returns (wav, mel, lin) like ``Synthesizer``.
        The timeout keeps a dead worker from blocking callers forever."""
        if not self._worker.is_alive():
            raise RuntimeError("DynamicBatcher worker thread is dead")
        fut: Future = Future()
        self._q.put((text, speaker_id, fut))
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

    # --- worker ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            batch, stop = _gather(self._q, self.max_batch, self.window)
            for group in _partition(batch):
                self._dispatch_group(group)
            if stop:
                return

    def _dispatch_group(self, batch, _retry: bool = False) -> None:
        texts = [t for t, _s, _f in batch]
        speakers = [s for _t, s, _f in batch]
        if not _retry:
            # a failed window re-runs its items one by one; counting the
            # retries would book every window-mate twice in /stats
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                               len(batch))
        try:
            wavs, mels, lins = self._synth.synthesize_batch(texts, speakers)
        except Exception as e:
            if len(batch) > 1:
                # one bad request (a ClientError, say) fails alone
                for item in batch:
                    self._dispatch_group([item], _retry=True)
                return
            for _t, _s, fut in batch:
                if not fut.cancelled():
                    fut.set_exception(e)
            return
        for i, (_t, _s, fut) in enumerate(batch):
            if not fut.cancelled():
                fut.set_result((wavs[i], mels[i], lins[i]))


_STREAM_END = object()


class StreamBatcher:
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
        self.max_batch = max(1, int(max_batch))
        self.window = max(0.0, float(window_ms)) / 1000.0
        self._q: queue.Queue = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="stream-batcher")
        self._worker.start()

    def stream(self, text: str, speaker_id: int = -1,
               timeout: Optional[float] = 600.0):
        """Enqueue and yield waveform chunks as the batched pipeline makes
        them. ``timeout`` bounds the wait for each chunk."""
        if not self._worker.is_alive():
            raise RuntimeError("StreamBatcher worker thread is dead")
        out: queue.Queue = queue.Queue()
        self._q.put((text, speaker_id, out))
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

    # --- worker ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            batch, stop = _gather(self._q, self.max_batch, self.window)
            for group in _partition(batch):
                self._dispatch_group(group)
            if stop:
                return

    def _dispatch_group(self, batch) -> None:
        texts = [t for t, _s, _q in batch]
        speakers = [s for _t, s, _q in batch]
        queues = [q for _t, _s, q in batch]
        self.stats["requests"] += len(batch)
        self.stats["batches"] += 1
        self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                           len(batch))
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
