"""Per-utterance features with an on-disk cache: port of
``nspeech_tpu/data/features.py``.

Load (``native.load_wav``: the C++ loader's WAV or FLAC decoding and
polyphase resampling, as the JAX package loads), trim (``dsp/trim.py``),
then the linear and mel spectrograms of ``dsp/audio.py``, on the host CPU.
A cache directory holds one ``.npz`` per utterance (``wav``, ``linear``,
``mel``) under the JAX package's key, so either package reads the other's
cache.
"""

from __future__ import annotations

import hashlib
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from nspeech_tpu_torch.config import Config
from nspeech_tpu_torch.dsp.audio import spectrograms
from nspeech_tpu_torch.dsp.trim import trim_wav
from nspeech_tpu_torch import native


class Utterance(NamedTuple):
    utt_id: str
    wav: np.ndarray           # trimmed waveform, float32 [-1, 1]
    linear: np.ndarray        # [T, num_freq] normalized dB spectrogram
    mel: np.ndarray           # [T, num_mels]
    n_frames: int


def _cache_path(cache_dir: str, wav_path: str, cfg: Config) -> str:
    # Every input that changes the feature values is in the key: the
    # feature hparams and the wav file's identity (mtime and size, so a
    # replaced wav does not reuse stale features).
    st = os.stat(wav_path)
    key = "%s|%d|%d|%d|%d|%d|%g|%g|%g|%g|%g" % (
        os.path.abspath(wav_path), st.st_mtime_ns, st.st_size,
        cfg.sample_rate, cfg.num_freq,
        cfg.num_mels, cfg.frame_shift_ms, cfg.frame_length_ms,
        cfg.preemphasis, cfg.ref_level_db, cfg.min_level_db,
    )
    digest = hashlib.sha1(key.encode()).hexdigest()[:20]
    return os.path.join(cache_dir, digest + ".npz")


def process_utterance(wav_path: str, cfg: Config,
                      cache_dir: Optional[str] = None) -> Utterance:
    """Load, trim and featurize one utterance (read from and written to
    ``cache_dir`` when given)."""
    utt_id = os.path.splitext(os.path.basename(wav_path))[0]
    if cache_dir:
        path = _cache_path(cache_dir, wav_path, cfg)
        if os.path.exists(path):
            with np.load(path) as z:
                return Utterance(utt_id, z["wav"], z["linear"], z["mel"],
                                 int(z["linear"].shape[0]))

    wav = trim_wav(native.load_wav(wav_path, cfg.sample_rate))
    linear, mel = spectrograms(wav, cfg)

    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp.%d.npz" % os.getpid()  # np.savez appends .npz otherwise
        np.savez(tmp, wav=wav, linear=linear, mel=mel)
        os.replace(tmp, path)
    return Utterance(utt_id, wav, linear, mel, linear.shape[0])


def build_from_paths(wav_paths, cfg: Config, cache_dir: Optional[str] = None,
                     num_workers: int = 1):
    """Featurize many utterances, in ``num_workers`` spawned processes
    (each on one CPU thread) when more than one."""
    if num_workers <= 1:
        return [process_utterance(p, cfg, cache_dir) for p in wav_paths]
    native.build()   # once here, not in every worker at once
    with ProcessPoolExecutor(max_workers=num_workers,
                             mp_context=mp.get_context("spawn"),
                             initializer=torch.set_num_threads,
                             initargs=(1,)) as ex:
        futures = [ex.submit(partial(process_utterance, p, cfg, cache_dir))
                   for p in wav_paths]
        return [f.result() for f in futures]
