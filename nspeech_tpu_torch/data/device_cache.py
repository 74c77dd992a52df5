"""Device-resident batch cache for corpora that fit in device memory: port
of ``nspeech_tpu/data/device_cache.py``.

The feeder's batches of ``n_epoch_variants`` epochs are featurized, padded
to one shape (the largest text and frame lengths among them) and held as
tensors on the training device; the stream then reshuffles their order
every epoch from ``seed`` and moves nothing from the host per step. The
batch composition is fixed after the warm-up, the trade the JAX package
makes for a corpus that fits. The padded waveforms are not kept: the
train step does not read them. In a data-parallel run (``dp``) each rank
caches its own feeder shard's rows on its own card, padded to the
largest lengths over every rank's batches (one all-reduce), so that the
ranks' batches of a step share one shape.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from nspeech_tpu_torch.data.feeder import Batch, DataFeeder, pad_batch
from nspeech_tpu_torch.train.loop import TacotronBatch, batch_to_device


class DeviceCachedBatches:
    def __init__(self, feeder: DataFeeder, device, n_epoch_variants: int = 4,
                 seed: int = 0, dp=None):
        host: List[Batch] = []
        for epoch in range(n_epoch_variants):
            host.extend(feeder.epoch_batches(epoch))
        if not host:
            raise RuntimeError("feeder produced no batches to cache")
        lengths = [max(b.inputs.shape[1] for b in host),
                   max(b.mel_targets.shape[1] for b in host)]
        if dp is not None:
            from nspeech_tpu_torch.parallel.collectives import max_over_ranks

            lengths = max_over_ranks(lengths, dp)
        self._batches: List[TacotronBatch] = [
            batch_to_device(pad_batch(b, *lengths), device) for b in host]
        self._rng = np.random.default_rng(seed)
        self.n_batches = len(self._batches)
        self.cached_mb = sum(x.numel() * x.element_size()
                             for b in self._batches for x in b) / 1e6

    def batches(self) -> Iterator[TacotronBatch]:
        """Endless stream of the cached batches, their order reshuffled
        every epoch."""
        while True:
            for i in self._rng.permutation(self.n_batches):
                yield self._batches[int(i)]
