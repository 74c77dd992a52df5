"""Device-resident batch cache for corpora that fit in device memory: port
of ``nspeech_tpu/data/device_cache.py`` for one process.

The feeder's batches of ``n_epoch_variants`` epochs are featurized, padded
to one shape (the largest text and frame lengths among them) and held as
tensors on the training device; the stream then reshuffles their order
every epoch from ``seed`` and moves nothing from the host per step. The
batch composition is fixed after the warm-up, the trade the JAX package
makes for a corpus that fits. The padded waveforms are not kept: the
train step does not read them.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from nspeech_tpu_torch.data.feeder import Batch, DataFeeder
from nspeech_tpu_torch.train.loop import TacotronBatch, batch_to_device


class DeviceCachedBatches:
    def __init__(self, feeder: DataFeeder, device, n_epoch_variants: int = 4,
                 seed: int = 0):
        host: List[Batch] = []
        for epoch in range(n_epoch_variants):
            host.extend(feeder.epoch_batches(epoch))
        if not host:
            raise RuntimeError("feeder produced no batches to cache")
        frame_len = max(b.mel_targets.shape[1] for b in host)
        text_len = max(b.inputs.shape[1] for b in host)
        self._batches: List[TacotronBatch] = []
        for b in host:
            dt = text_len - b.inputs.shape[1]
            df = frame_len - b.mel_targets.shape[1]
            b = b._replace(
                inputs=np.pad(b.inputs, ((0, 0), (0, dt))),
                mel_targets=np.pad(b.mel_targets, ((0, 0), (0, df), (0, 0))),
                linear_targets=np.pad(b.linear_targets, ((0, 0), (0, df), (0, 0))))
            self._batches.append(batch_to_device(b, device))
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
