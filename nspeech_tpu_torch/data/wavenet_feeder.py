"""Host input pipeline for WaveNet training: port of
``nspeech_tpu/data/wavenet_feeder.py``.

Each utterance is read by the C++ loader (``native.load_wav``, as the
JAX package reads it), silence-trimmed (``dsp/trim.py`` ``trim_silence`` at
``silence_threshold``), left-padded by the receptive field and cut into
windows of ``receptive_field + sample_size`` samples with a hop of
``sample_size``, so consecutive windows overlap by the receptive field.
Local conditioning is the mel of the padded utterance, computed once per
visit on the host CPU (``dsp/audio.py`` ``spectrograms``) and shipped at
frame rate with a per-window phase (``frame_lc``, the default; the train
step upsamples it on the device, ``ops/upsample.py`` ``batch_lc``) or, in
the legacy layout, upsampled on the host to one row per sample. In GTA
mode the mel is the acoustic model's teacher-forced prediction exported by
``data/gta.py``. The epoch order is ``numpy.random.default_rng((seed,
epoch))``, as in the JAX package, so one corpus and seed give the same
batches in both.

The feeder runs inline in the consumer's thread. While a profile runs
(``utils/profiling.py``) it records ``feeder.featurize`` per utterance
visited (the load, the trim and the mel; attribute ``samples``, the
padded length) and ``feeder.make`` per batch assembled (the stacking;
attribute ``utterances``, how many its windows came from). Both close
before the feeder yields.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np

from nspeech_tpu_torch.config import Config, stft_params
from nspeech_tpu_torch.data.corpus import Item, build_speaker_map, load_items
from nspeech_tpu_torch.dsp.audio import spectrograms
from nspeech_tpu_torch.dsp.trim import trim_silence
from nspeech_tpu_torch.native import load_wav
from nspeech_tpu_torch.utils import profiling


class WaveNetBatch(NamedTuple):
    audio: np.ndarray        # [B, receptive_field + sample_size] float32
    speaker_ids: np.ndarray  # [B] int32
    # mel_phase None: ``mel`` is per-sample [B, window, M] (legacy layout).
    # mel_phase [B] int32: ``mel`` is frame-rate rows [B, F, M] whose first
    # row is anchored mel_phase[b] samples before the window's start.
    mel: np.ndarray
    mel_phase: Optional[np.ndarray] = None


def upsample_frames(frames: np.ndarray, hop_length: int, length: int) -> np.ndarray:
    """[T_frames, C] frame features -> [length, C] per-sample features.

    Each frame t is anchored at sample t * hop_length (librosa centered-frame
    convention); values between anchors are linearly interpolated.
    """
    t_frames = frames.shape[0]
    anchors = np.arange(t_frames) * hop_length
    positions = np.arange(length)
    out = np.empty((length, frames.shape[1]), dtype=np.float32)
    for c in range(frames.shape[1]):
        out[:, c] = np.interp(positions, anchors, frames[:, c])
    return out


class WaveNetFeeder:
    """Fixed-shape window stream for WaveNet training. A rank of a
    data-parallel run reads ``items[shard_index::shard_count]`` (the
    speaker map stays global)."""

    def __init__(
        self,
        input_paths: Dict[str, str] | List[Item],
        receptive_field: int,
        cfg: Config,
        seed: int = 0,
        frame_lc: bool = True,
        gta_dir: Optional[str] = None,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self._cfg = cfg
        self._seed = seed
        self.receptive_field = receptive_field
        self.sample_size = cfg.sample_size
        self.window = receptive_field + cfg.sample_size
        self.silence_threshold = cfg.get("silence_threshold", 0.1)
        _, self._hop, _ = stft_params(cfg)
        self.frame_lc = frame_lc
        # rows needed so the last window sample (phase + window - 1 samples
        # past row 0's anchor) still has an i1 row
        self.frames_per_window = (self.window + self._hop - 2) // self._hop + 2
        # GTA mode: stored row i anchors at sample i*hop of the TRIMMED wav,
        # so the left pad is rounded up to whole hops and covered with
        # silence-mel rows: the anchor grid is the computed-mel layout's.
        self.gta_dir = gta_dir
        self._silence_row: Optional[np.ndarray] = None
        if gta_dir is not None:
            from nspeech_tpu_torch.data.gta import check_fingerprint

            check_fingerprint(gta_dir, cfg)
            self._gta_pad = -(-receptive_field // self._hop) * self._hop

        items = load_items(input_paths) if isinstance(input_paths, dict) else list(input_paths)
        self.speaker2id = build_speaker_map(items)
        self.num_speakers = len(self.speaker2id)
        self._items = items[shard_index::shard_count]

    def _gta_mel(self, wav_path: str, trimmed_len: int) -> np.ndarray:
        """The exported teacher-forced mel of one utterance with silence
        rows prepended over the (hop-rounded) receptive-field pad."""
        from nspeech_tpu_torch.data.gta import gta_path

        path = gta_path(self.gta_dir, wav_path)
        if not os.path.exists(path):
            raise FileNotFoundError(
                "No GTA mel for %r in %r — re-run export_gta over this "
                "corpus" % (wav_path, self.gta_dir))
        mel = np.load(path)
        expected = 1 + trimmed_len // self._hop
        if mel.shape[0] != expected:
            raise ValueError(
                "GTA mel for %r has %d frames, expected %d — the wav or "
                "trim settings changed since export" %
                (wav_path, mel.shape[0], expected))
        if self._silence_row is None:
            # the mel row of digital silence (the normalized dB floor): what
            # the computed-mel path yields over the zero left pad
            n_fft = stft_params(self._cfg)[0]
            _, zmel = spectrograms(
                np.zeros(max(4 * self._hop, 2 * n_fft), np.float32), self._cfg)
            self._silence_row = zmel[:1]
        pad_rows = self._gta_pad // self._hop
        return np.concatenate(
            [np.repeat(self._silence_row, pad_rows, axis=0), mel], axis=0)

    def _utterance_windows(self, item: Item):
        """Yield (audio_window, speaker_id, mel_window, phase) for one
        utterance (phase None in the per-sample layout)."""
        wav_path, _text, local_speaker, dataset_id = item
        speaker_id = self.speaker2id[(dataset_id, str(local_speaker))]
        with profiling.span("feeder.featurize") as sp:
            wav = load_wav(wav_path, self._cfg.sample_rate)
            if self.silence_threshold is not None:
                wav = trim_silence(wav, self.silence_threshold)
                if wav.size == 0:
                    return  # silence-only utterance: skipped
            if self.gta_dir is not None:
                mel = self._gta_mel(wav_path, len(wav))
                wav = np.pad(wav, (self._gta_pad, 0))
            else:
                wav = np.pad(wav, (self.receptive_field, 0))
                _, mel = spectrograms(wav, self._cfg)
            if not self.frame_lc:
                mel_samples = upsample_frames(mel, self._hop, len(wav))
            attrs = getattr(sp, "attrs", None)      # None outside a profile
            if attrs is not None:
                attrs["samples"] = len(wav)
        offset = 0
        while len(wav) - offset > self.window:
            if self.frame_lc:
                i_start = offset // self._hop
                phase = offset - i_start * self._hop
                rows = mel[i_start: i_start + self.frames_per_window]
                if rows.shape[0] < self.frames_per_window:  # edge-hold pad
                    pad = self.frames_per_window - rows.shape[0]
                    rows = np.concatenate(
                        [rows, np.repeat(rows[-1:], pad, axis=0)], axis=0)
                lc = (rows, phase)
            else:
                lc = (mel_samples[offset: offset + self.window], None)
            yield (wav[offset: offset + self.window], speaker_id) + lc
            offset += self.sample_size

    def batches(self) -> Iterator[WaveNetBatch]:
        """Endless fixed-shape batch stream: the items in the order of
        ``default_rng((seed, epoch)).permutation`` each epoch, their windows
        in order, ``batch_size`` windows per batch across utterances.
        Raises when a whole epoch holds no window (every utterance shorter
        than one), where the JAX package's stream would spin."""
        n = self._cfg.batch_size
        epoch = 0
        buf: list = []
        sources: set = set()        # the items the buffered windows came from
        while True:
            order = np.random.default_rng((self._seed, epoch)).permutation(
                len(self._items))
            windows = 0
            for i in order:
                for window in self._utterance_windows(self._items[i]):
                    windows += 1
                    buf.append(window)
                    sources.add(i)
                    if len(buf) == n:
                        with profiling.span("feeder.make",
                                            utterances=len(sources)):
                            audio, spk, mel, phase = zip(*buf)
                            batch = WaveNetBatch(
                                np.stack(audio).astype(np.float32),
                                np.asarray(spk, dtype=np.int32),
                                np.stack(mel).astype(np.float32),
                                (np.asarray(phase, dtype=np.int32)
                                 if self.frame_lc else None))
                        yield batch
                        buf = []
                        sources = set()
            if not windows:
                raise RuntimeError(
                    "no utterance of %d items is longer than one window of "
                    "%d samples" % (len(self._items), self.window))
            epoch += 1
