"""Host input pipeline for the Tacotron models: port of
``nspeech_tpu/data/feeder.py``.

Groups of ``batch_size * batch_group_size`` examples are sorted by output
length, cut into batches, and the batches and their rows shuffled; inputs
are padded with symbol id 0 and targets to a multiple of
``outputs_per_step`` with at least one pure-padding frame; padded shapes
are rounded up to buckets (``bucket_text`` symbols, ``bucket_frames``
frames). The stream is deterministic per (seed, epoch) through the same
numpy generators as the JAX package's feeder, so one corpus and seed give
the same batches in the same order in both packages. Batches are numpy
arrays; one background thread prefetches them (featurizing on the host
CPU) and passes its errors on to the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np

from nspeech_tpu_torch.config import Config, stft_params
from nspeech_tpu_torch.data.corpus import Item, build_speaker_map, load_items
from nspeech_tpu_torch.data.features import process_utterance
from nspeech_tpu_torch.text import text_to_sequence
from nspeech_tpu_torch.text.symbols import PAD_ID

_P_CMUDICT = 0.5  # probability of ARPAbet substitution per word


class Batch(NamedTuple):
    inputs: np.ndarray          # [B, T_in] int32 symbol ids
    input_lengths: np.ndarray   # [B] int32
    speaker_ids: np.ndarray     # [B] int32
    mel_targets: np.ndarray     # [B, T_out, M] float32
    linear_targets: np.ndarray  # [B, T_out, F] float32
    audio: np.ndarray           # [B, T_samples] float32 (padded waveforms)


# ---------------------------------------------------------------------------
# Padding / bucketing math
# ---------------------------------------------------------------------------

def round_up(x: int, multiple: int) -> int:
    remainder = x % multiple
    return x if remainder == 0 else x + multiple - remainder


def pad_inputs(seqs: List[np.ndarray], length: Optional[int] = None) -> np.ndarray:
    max_len = max(len(s) for s in seqs)
    length = max(length or 0, max_len)
    return np.stack([
        np.pad(s, (0, length - len(s)), constant_values=PAD_ID) for s in seqs
    ])


def pad_targets(targets: List[np.ndarray], r: int,
                length: Optional[int] = None) -> np.ndarray:
    # +1 guarantees at least one pure-padding frame
    max_len = round_up(max(len(t) for t in targets) + 1, r)
    length = round_up(max(length or 0, max_len), r)
    return np.stack([
        np.pad(t, [(0, length - len(t)), (0, 0)], constant_values=0.0)
        for t in targets
    ])


def pad_batch(batch: Batch, text_len: int, frame_len: int) -> Batch:
    """``batch`` with its inputs padded to ``text_len`` symbols and its
    targets to ``frame_len`` frames (the waveforms, which the train step
    does not read, as they are): one shape for a set of batches (the
    device cache's, the ranks' of a data-parallel step)."""
    dt = text_len - batch.inputs.shape[1]
    df = frame_len - batch.mel_targets.shape[1]
    return batch._replace(
        inputs=np.pad(batch.inputs, ((0, 0), (0, dt))),
        mel_targets=np.pad(batch.mel_targets, ((0, 0), (0, df), (0, 0))),
        linear_targets=np.pad(batch.linear_targets, ((0, 0), (0, df), (0, 0))))


class DataFeeder:
    """Bucketed, shape-stable batch stream.

    Args:
      input_paths: dict corpus_name -> directory, or a list of items.
      cfg: hyperparameters.
      cache_dir: on-disk feature cache directory (None disables).
      bucket_text / bucket_frames: shape-bucket granularity; padded batch
        shapes are rounded up to these multiples (the JAX package's
        buckets, which bound its recompiles).
        bucket_frames must be a multiple of outputs_per_step.
      cmudict: optional CMUDict for random ARPAbet substitution
        (each word with probability 0.5 in an example drawn with
        probability 0.5).
      shard_index / shard_count: this rank's shard of the items,
        ``items[shard_index::shard_count]``, taken after the speaker map
        and the holdout split, which stay global (as the JAX package's).
    """

    def __init__(
        self,
        input_paths: Dict[str, str] | List[Item],
        cfg: Config,
        cache_dir: Optional[str] = None,
        seed: int = 0,
        bucket_text: int = 32,
        bucket_frames: int = 100,
        cmudict=None,
        prefetch: int = 4,
        holdout: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self._cfg = cfg
        self._cache_dir = cache_dir
        self._cleaners = [x.strip() for x in cfg.cleaners.split(",")]
        self._seed = seed
        r = cfg.outputs_per_step
        if bucket_frames % r != 0:
            bucket_frames = round_up(bucket_frames, r)
        self._bucket_text = bucket_text
        self._bucket_frames = bucket_frames
        _, self._hop, _ = stft_params(cfg)
        self._cmudict = cmudict
        self._prefetch = prefetch

        items = load_items(input_paths) if isinstance(input_paths, dict) else list(input_paths)
        # Speaker map over the FULL corpus (holdout items keep their ids).
        self.speaker2id = build_speaker_map(items)
        self.num_speakers = len(self.speaker2id)
        # Held-out dev set: evenly spaced over the (deterministic) item
        # list, so it spreads across corpora/speakers, is identical on
        # every host and across resumes, and never enters training.
        self.holdout_items: List[Item] = []
        if holdout:
            if holdout >= len(items):
                raise ValueError(
                    "holdout=%d must be smaller than the corpus (%d items)"
                    % (holdout, len(items)))
            idx = set(np.linspace(0, len(items) - 1, holdout)
                      .astype(int).tolist())
            self.holdout_items = [items[i] for i in sorted(idx)]
            items = [it for i, it in enumerate(items) if i not in idx]
        self._items = items[shard_index::shard_count]
        self._memo: dict = {}

    def holdout_batch(self) -> Batch:
        """One padded batch of the held-out items (teacher-forcing eval
        targets). Deterministic: CMUDict substitution is bypassed."""
        if not self.holdout_items:
            raise ValueError("feeder was built with holdout=0")
        saved, self._cmudict = self._cmudict, None
        try:
            rng = np.random.default_rng(0)
            examples = [self._example(it, rng) for it in self.holdout_items]
        finally:
            self._cmudict = saved
        return self._make_batch(examples)

    # -- example level ------------------------------------------------------

    def _example(self, item: Item, rng: np.random.Generator):
        wav_path, text, local_speaker, dataset_id = item
        speaker_id = self.speaker2id[(dataset_id, str(local_speaker))]
        key = (wav_path, dataset_id)
        utt = self._memo.get(key)
        if utt is None:
            utt = process_utterance(wav_path, self._cfg, self._cache_dir)
            if self._cache_dir is None:
                self._memo[key] = utt
        if self._cmudict is not None and rng.random() < _P_CMUDICT:
            text = " ".join(self._maybe_arpabet(w, rng) for w in text.split(" "))
        ids = np.asarray(text_to_sequence(text, self._cleaners), dtype=np.int32)
        return ids, utt.wav, speaker_id, utt.mel, utt.linear, utt.n_frames

    def _maybe_arpabet(self, word: str, rng: np.random.Generator) -> str:
        pron = self._cmudict.lookup(word)
        return "{%s}" % pron[0] if pron is not None and rng.random() < 0.5 else word

    # -- batch level --------------------------------------------------------

    def _make_batch(self, examples) -> Batch:
        r = self._cfg.outputs_per_step
        text_len = round_up(max(len(e[0]) for e in examples), self._bucket_text)
        frame_len = round_up(max(len(e[4]) for e in examples) + 1, self._bucket_frames)
        inputs = pad_inputs([e[0] for e in examples], text_len)
        input_lengths = np.asarray([len(e[0]) for e in examples], dtype=np.int32)
        # bucketed like the frames, as in the JAX package's batches
        audio_len = round_up(max(len(e[1]) for e in examples),
                             self._bucket_frames * self._hop)
        audio = pad_inputs([e[1] for e in examples], audio_len).astype(np.float32)
        speaker_ids = np.asarray([e[2] for e in examples], dtype=np.int32)
        mel = pad_targets([e[3] for e in examples], r, frame_len).astype(np.float32)
        linear = pad_targets([e[4] for e in examples], r, frame_len).astype(np.float32)
        return Batch(inputs, input_lengths, speaker_ids, mel, linear, audio)

    def epoch_batches(self, epoch: int) -> Iterator[Batch]:
        """Deterministic batch stream for one pass over the items."""
        cfg = self._cfg
        rng = np.random.default_rng((self._seed, epoch))
        order = rng.permutation(len(self._items))
        n = cfg.batch_size
        if len(order) == 0:
            raise RuntimeError(
                "DataFeeder has no items (all held out?) — nothing to batch")
        if len(order) < n:
            # Tiny corpus: wrap around so a full batch still forms.
            # Without this an epoch yields zero batches and the prefetch
            # producer would spin forever.
            reps = -(-n // len(order))
            order = np.concatenate(
                [rng.permutation(len(self._items)) for _ in range(reps)])
        group_size = n * cfg.batch_group_size
        for g in range(0, len(order) - n + 1, group_size):
            group_idx = order[g: g + group_size]
            examples = [self._example(self._items[i], rng) for i in group_idx]
            # Bucket by output length to reduce padding.
            examples.sort(key=lambda e: e[-1])
            batches = [examples[i: i + n] for i in range(0, len(examples) - n + 1, n)]
            rng.shuffle(batches)
            for batch in batches:
                rng.shuffle(batch)
                yield self._make_batch(batch)

    def batches(self) -> Iterator[Batch]:
        """Endless batch stream with background prefetch."""
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        error: list = []

        def producer():
            epoch = 0
            try:
                while not stop.is_set():
                    yielded = 0
                    for b in self.epoch_batches(epoch):
                        q.put(b)
                        yielded += 1
                        if stop.is_set():
                            return
                    if yielded == 0:  # defensive: never silently spin
                        raise RuntimeError(
                            f"epoch {epoch} produced no batches "
                            f"({len(self._items)} items, batch_size="
                            f"{self._cfg.batch_size})")
                    epoch += 1
            except BaseException as e:  # propagate to consumer
                error.append(e)
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    raise error[0]
                yield b
        finally:
            stop.set()
            # Drain until the producer sees the flag (after the batch it is
            # making): a thread left running inside a torch op when the
            # interpreter exits aborts the process.
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
