"""Ground-truth-aligned (GTA) mel export for vocoder fine-tuning: port of
``nspeech_tpu/data/gta.py``.

The acoustic model runs teacher-forced over the training corpus (frame t
conditioned on the true frames before it, so the predictions stay aligned
with the audio) and its predicted mels are saved; ``WaveNetFeeder(gta_dir=
...)`` then trains the vocoder on the features it sees in serving.

Alignment contract, shared with the feeder and with the JAX package:
- each wav is trimmed as the vocoder feeder trims it (``trim_silence`` at
  ``silence_threshold``), so stored row ``i`` is anchored at sample
  ``i * hop_length`` of the trimmed waveform;
- each mel is ``<sha1 of the wav's absolute path>[:20].npy``, the JAX
  package's file name, and ``manifest.json`` records the feature
  fingerprint (every hparam that changes the mel values or the trim); the
  feeder refuses a directory whose fingerprint differs from its config.

Utterances are length-sorted and run in batches of a fixed size, text and
frames padded to buckets, as the JAX package batches them.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from nspeech_tpu_torch.config import Config, stft_params
from nspeech_tpu_torch.ops.policy import upcast

MANIFEST_FILE = "manifest.json"

# every config key that changes the mel values or the trim
_FINGERPRINT_KEYS = (
    "sample_rate", "num_freq", "num_mels", "frame_shift_ms",
    "frame_length_ms", "preemphasis", "ref_level_db", "min_level_db",
    "silence_threshold",
)


def fingerprint(cfg: Config) -> Dict[str, float]:
    return {k: cfg.get(k) for k in _FINGERPRINT_KEYS}


def gta_path(gta_dir: str, wav_path: str) -> str:
    """The mel file of one wav (the same name on export and load)."""
    digest = hashlib.sha1(os.path.abspath(wav_path).encode()).hexdigest()[:20]
    return os.path.join(gta_dir, digest + ".npy")


def load_manifest(gta_dir: str) -> Dict:
    with open(os.path.join(gta_dir, MANIFEST_FILE), "r", encoding="utf-8") as f:
        return json.load(f)


def check_fingerprint(gta_dir: str, cfg: Config) -> Dict:
    """Raise unless the GTA directory was exported under feature hparams
    equal to ``cfg``'s; returns the manifest."""
    manifest = load_manifest(gta_dir)
    theirs = manifest["fingerprint"]
    ours = fingerprint(cfg)
    diffs = {k: (theirs.get(k), ours[k]) for k in ours if theirs.get(k) != ours[k]}
    if diffs:
        raise ValueError(
            "GTA dir %r was exported under different feature hparams; "
            "mismatched keys (exported, current): %r" % (gta_dir, diffs))
    return manifest


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def export_gta(
    checkpoint_dir: str,
    input_paths,
    out_dir: str,
    model_name: Optional[str] = None,
    overrides: str = "",
    step: Optional[int] = None,
    batch_size: int = 8,
    text_bucket: int = 32,
    frame_bucket: int = 128,
    device="cuda",
    log=print,
) -> Dict:
    """Teacher-forced mel export over a corpus from an acoustic model's
    serving checkpoint, on ``device``. Returns the manifest."""
    from nspeech_tpu_torch.data.corpus import build_speaker_map, load_items
    from nspeech_tpu_torch.dsp.audio import spectrograms
    from nspeech_tpu_torch.dsp.trim import trim_silence
    from nspeech_tpu_torch.models import WaveNet, create_model
    from nspeech_tpu_torch.native import load_wav
    from nspeech_tpu_torch.text import text_to_sequence
    from nspeech_tpu_torch.text.symbols import PAD_ID
    from nspeech_tpu_torch.train.checkpoint import load_serving_params
    from nspeech_tpu_torch.train.metadata import (config_from_checkpoint,
                                                  load_run_metadata)

    cfg, name = config_from_checkpoint(checkpoint_dir, model_name, overrides)
    model = create_model(name, cfg)
    if isinstance(model, WaveNet):
        raise ValueError(f"--model {name}: GTA export needs an acoustic "
                         "model (taco1 or taco2)")
    params, bn_state = load_serving_params(checkpoint_dir, model, step=step,
                                           device=device)
    r = cfg.outputs_per_step
    frame_bucket = _round_up(frame_bucket, r)
    _, hop, _ = stft_params(cfg)
    threshold = cfg.get("silence_threshold", 0.1)

    items = (load_items(input_paths) if isinstance(input_paths, dict)
             else list(input_paths))
    if not items:
        raise ValueError("No corpus items to export")
    # speaker ids of the acoustic model's training run: the map saved
    # beside its checkpoint when there is one
    meta = load_run_metadata(checkpoint_dir) or {}
    if "speaker_map" in meta:
        speaker2id = {(ds, str(spk)): idx for ds, spk, idx in meta["speaker_map"]}
    else:
        speaker2id = build_speaker_map(items)
    cleaners = [c.strip() for c in cfg.cleaners.split(",")]

    prepared = []  # (item_index, ids, mel [F, M]), featurized on the host
    for idx, (wav_path, text, _spk, _ds) in enumerate(items):
        wav = load_wav(wav_path, cfg.sample_rate)
        if threshold is not None:
            wav = trim_silence(wav, threshold)
        if wav.size == 0:
            log("GTA: skipping silence-only %s" % wav_path)
            continue
        _, mel = spectrograms(wav, cfg)
        seq = np.asarray(text_to_sequence(text, cleaners), np.int32)
        prepared.append((idx, seq, mel))
    prepared.sort(key=lambda p: p[2].shape[0])

    os.makedirs(out_dir, exist_ok=True)
    files: Dict[str, str] = {}
    for start in range(0, len(prepared), batch_size):
        chunk = prepared[start: start + batch_size]
        t_text = _round_up(max(p[1].shape[0] for p in chunk), text_bucket)
        t_mel = _round_up(_round_up(max(p[2].shape[0] for p in chunk), r),
                          frame_bucket)
        n = batch_size  # a fixed batch, as JAX compiles one program per bucket
        ids = np.full((n, t_text), PAD_ID, np.int64)
        lengths = np.zeros((n,), np.int64)
        spk = np.zeros((n,), np.int64)
        mels = np.zeros((n, t_mel, cfg.num_mels), np.float32)
        for b, (idx, seq, mel) in enumerate(chunk):
            ids[b, : seq.shape[0]] = seq
            lengths[b] = seq.shape[0]
            _, _, local_spk, dataset_id = items[idx]
            key = (dataset_id, str(local_spk))
            if cfg.get("num_speakers", 1) > 1:
                if key not in speaker2id:
                    raise ValueError(
                        "Speaker %r not in the checkpoint's speaker map" % (key,))
                spk[b] = speaker2id[key]
            mels[b, : mel.shape[0]] = mel
        with torch.no_grad():
            outputs, _ = model.forward_train(
                params, bn_state, *(torch.from_numpy(x).to(device)
                                    for x in (ids, lengths, spk, mels)),
                is_training=False)
        out = upcast(outputs["mel_outputs"]).cpu().numpy()
        for b, (idx, _seq, mel) in enumerate(chunk):
            wav_path = items[idx][0]
            path = gta_path(out_dir, wav_path)
            # crop the bucket padding: stored rows align 1:1 with the
            # trimmed waveform's frames
            np.save(path, out[b, : mel.shape[0]].astype(np.float32))
            files[os.path.abspath(wav_path)] = os.path.basename(path)
        log("GTA: %d/%d utterances exported" %
            (min(start + batch_size, len(prepared)), len(prepared)))

    manifest = {
        "fingerprint": fingerprint(cfg),
        "model": name,
        "checkpoint": os.path.abspath(checkpoint_dir),
        "step": step,
        "count": len(files),
        "files": files,
    }
    tmp = os.path.join(out_dir, MANIFEST_FILE + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(out_dir, MANIFEST_FILE))
    return manifest
