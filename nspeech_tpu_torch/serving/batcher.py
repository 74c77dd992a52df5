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
``window_ms`` for companions (up to ``max_batch``) and splits the window
into groups. ``DynamicBatcher`` runs each group's batched call on the
worker, one at a time: a one-shot group takes the synthesizer's whole
batch for about a second, and nothing of it could run beside another.
``StreamBatcher`` hands each group to a group slot (a thread and a CUDA
stream) and goes back to gathering as soon as a slot is free: a stream
is one sampler cluster, and the card holds many, so groups stream side
by side, as far as ``StreamingTTS`` admits them.

While a profile runs (``utils/profiling.py``) each group records
``batcher.group`` around its call, on the thread that runs it, with its
rows and the requests still queued at dispatch, and under it each of its
requests ``batcher.wait``, from the request's enqueue to the start of the
call.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, NamedTuple, Optional

import torch

from nspeech_tpu_torch.utils import profiling


# Groups a StreamBatcher streams at once. Each takes two CUDA streams (its
# decoder's and its sampler's), and the CUDA driver runs every stream
# through one of its hardware queues, 8 by default: two busy streams on one
# queue wait for each other's kernels, a decoder chunk for another group's
# 2-s sampler launch. On an H100 three concurrent groups kept each group's
# pace within 5% of a lone one's, and four did not (17.5k samples/s alone;
# 16.6k at three; 16.3k at four with 25% more host waits; in the stream
# cell four slots read playback at 0.76x real time, three at 0.86x).
GROUP_SLOTS = 3


class _Request(NamedTuple):
    text: str
    speaker_id: Any
    sink: Any                 # the caller's Future (one-shot) or chunk queue
    t_enq: Optional[int]      # enqueue time (profiling.stamp), None untraced
    t_arrive: float           # enqueue time (time.monotonic)


def _is_default(speaker_id) -> bool:
    return speaker_id is None or speaker_id < 0


def _gather(q: queue.Queue, max_batch: int, window: float,
            hold: Optional[Callable[[], float]] = None):
    """Block for a first item, then take more for ``window`` seconds (up
    to ``max_batch``), or, where ``hold`` (asked once the first item is
    in) gives longer, until that many seconds after the first item's
    arrival. Returns (batch, stop): ``stop`` when the close sentinel
    (None) arrived; the batch is then what came before it."""
    head = q.get()
    if head is None:
        return [], True
    batch = [head]
    deadline = time.monotonic() + window
    if hold is not None:
        deadline = max(deadline, head.t_arrive + hold())
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
    """What both batchers share: the request queue, the counts, and one
    worker thread that runs the subclass's ``_run``, which takes windows
    of requests (:func:`_gather`) and splits them (:func:`_partition`)."""

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
        self._q.put(_Request(text, speaker_id, sink, profiling.stamp(),
                             time.monotonic()))

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

    def _run(self) -> None:
        while True:
            batch, stop = _gather(self._q, self.max_batch, self.window)
            for group in _partition(batch):
                with _group_span(self._q, group):
                    self._dispatch_group(group)
            if stop:
                return

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


def _make_library_handles(device) -> None:
    """A product and a convolution on the current CUDA stream, so that
    the calling thread's cuBLAS, cuBLASLt and cuDNN handles and their
    workspaces exist before it streams. PyTorch makes them at a thread's
    first such op, and threads that made them in their first group while
    other groups streamed held up every group on an H100: a batcher's
    first three groups reached first audio up to 5.7 s late and played
    at 0.56-0.67x real time, where later groups took 0.6-0.7 s and
    0.89x."""
    x = torch.ones(4, 4, device=device)
    torch.nn.functional.linear(x, x, x[0])
    torch.mm(x, x)
    torch.nn.functional.conv1d(x[None], x[:, :, None])
    torch.cuda.current_stream(device).synchronize()


class StreamBatcher(_Batcher):
    """Dynamic batching for streaming requests.

    Wraps a ``StreamingTTS``: concurrent callers iterate :meth:`stream`;
    the worker groups the requests that arrive within ``window_ms`` of the
    first (up to ``max_batch``) and drives one ``stream_batch`` for the
    group, one carried sampler launch per chunk for all of its streams.
    Chunks go to each caller's queue as the batched pipeline yields them.

    Up to :data:`GROUP_SLOTS` groups stream at once, each on a slot: a
    thread and a CUDA stream the batcher makes once (each stream waits
    once on the stream current at construction, so the weights are
    ready; each thread makes its CUDA library handles before its first
    group). The worker gathers the next group as soon as a
    slot is free, so new arrivals start while earlier groups still stream,
    and ``StreamingTTS`` admits each when the card has room for its
    streams' clusters. A group that takes the last free slot gathers
    longer: until the longest a group has lately streamed, divided by the
    slots, after its first request's arrival (or ``max_batch``). Held
    groups then start that far apart at least, so a slot frees up about
    as the next is due, and arrivals never find every slot taken for a
    whole group's time; before any group has ended nothing is held. A
    failure mid-stream aborts its own group: its callers have partial
    audio already, so a per-item retry cannot apply. After :meth:`close`
    the worker ends once the groups in flight have ended.
    """

    def __init__(self, streamer, max_batch: int = 8,
                 window_ms: float = 20.0):
        if not hasattr(streamer, "stream_batch"):
            raise ValueError("streamer has no stream_batch")
        self._tts = streamer
        # the group slots: a thread each, with its job queue and its CUDA
        # stream (None where no weights are on a card); a slot puts its
        # job queue into _free whenever it can take a group
        self._free: queue.Queue = queue.Queue()
        self._jobs = [queue.Queue() for _ in range(GROUP_SLOTS)]
        self._group_s: deque = deque(maxlen=GROUP_SLOTS)   # latest groups' seconds
        origin = (torch.cuda.current_stream()
                  if torch.cuda.is_initialized() else None)
        self._slot_threads = []
        for i, jobs in enumerate(self._jobs):
            stream = None
            if origin is not None:
                stream = torch.cuda.Stream(origin.device)
                stream.wait_stream(origin)
            th = threading.Thread(target=self._slot, args=(jobs, stream),
                                  daemon=True, name=f"stream-slot-{i}")
            th.start()
            self._slot_threads.append(th)
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

    def _run(self) -> None:
        while True:
            slots = [self._free.get()]    # a group can start: gather it
            batch, stop = _gather(self._q, self.max_batch, self.window,
                                  self._hold)
            for group in _partition(batch):
                self._count(group)
                (slots.pop() if slots else self._free.get()).put(group)
            for slot in slots:
                self._free.put(slot)
            if stop:
                break
        for jobs in self._jobs:           # each slot ends after its group
            jobs.put(None)
        for th in self._slot_threads:
            th.join()

    def _hold(self) -> float:
        """Seconds a group gathers after its first request's arrival: the
        longest of the latest groups over the slots where it takes the
        last free one, else 0."""
        if not self._free.empty():
            return 0.0
        return max(list(self._group_s), default=0.0) / GROUP_SLOTS

    def _slot(self, jobs: queue.Queue, stream) -> None:
        """A group slot's thread: the groups handed to it, one at a time,
        each under its spans and on the slot's CUDA stream (None on the
        CPU); then the group's seconds, and the slot is free again."""
        with (contextlib.nullcontext() if stream is None
              else torch.cuda.stream(stream)):
            if stream is not None:
                _make_library_handles(stream.device)
            while True:
                self._free.put(jobs)
                group = jobs.get()
                if group is None:
                    return
                t0 = time.monotonic()
                try:
                    with _group_span(self._q, group):
                        self._dispatch_group(group)
                finally:
                    self._group_s.append(time.monotonic() - t0)

    def _dispatch_group(self, batch) -> None:
        texts = [r.text for r in batch]
        speakers = [r.speaker_id for r in batch]
        queues = [r.sink for r in batch]
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
