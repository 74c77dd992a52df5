"""Stop-threshold calibration from near-silence statistics: a numpy copy
of ``nspeech_tpu/train/stopcal.py``.

The Tacotron decoders stop a row at the first step whose every output
value lies within ``stop_threshold`` of zero (``models/decoder.py``). The
default 0.0 almost never fires on a trained L1 regressor; a useful
threshold sits above what the decoder emits once speech has ended and
below anything it emits within speech, and depends on the corpus.

* **floor**: per utterance, the quietest frame peak in the trailing
  ``tail`` frames. The 95th percentile of the floors is the level a stop
  must clear.
* **danger**: per utterance, the quietest window of ``r`` consecutive
  frames (by the window's largest frame peak) in the interior: where a
  threshold would cut speech (a step stops only when all its ``r`` frames
  are below it).

The recommendation is the geometric mean of the two percentiles when
the danger level exceeds the floor by more than 1.5 times, else 0.0
(early stop left off, the separation recorded).
:func:`stop_statistics_from_decodes` takes the statistics from a trained
model's own decodes instead (the right source on trimmed corpora), and
:func:`apply_threshold_to_run` writes the threshold into a run's
``config.json``, which every serving entry point reads.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np


def sliding_window_max(x: np.ndarray, w: int) -> np.ndarray:
    """Max over each length-``w`` window of a 1-D array (len >= w)."""
    if w <= 1:
        return x
    out = x[: len(x) - w + 1].copy()
    for k in range(1, w):
        np.maximum(out, x[k: len(x) - w + 1 + k], out)
    return out


def stop_statistics(mels: Iterable[np.ndarray], r: int = 2,
                    tail: int = 5) -> Dict[str, float]:
    """Compute the floor/danger distributions and a recommended
    ``stop_threshold`` from normalized mels ([T, M], values in [0, 1]).

    Returns a dict with the recommendation (``threshold``; 0.0 = early
    stop unsafe on this corpus), the two percentile levels
    (``floor_p95``, ``danger_p05``), their ``separation`` ratio, and the
    sample count.
    """
    floors: List[float] = []
    dangers: List[float] = []
    for mel in mels:
        mel = np.asarray(mel)
        if mel.ndim != 2 or mel.shape[0] < max(r, tail) + r:
            continue
        peaks = mel.max(axis=1)
        floors.append(float(peaks[-tail:].min()))
        interior = peaks[: len(peaks) - tail]
        if len(interior) >= r:
            dangers.append(float(sliding_window_max(interior, r).min()))
    if not floors or not dangers:
        return {"threshold": 0.0, "floor_p95": float("nan"),
                "danger_p05": float("nan"), "separation": 0.0,
                "n_utterances": len(floors)}
    floor_hi = float(np.percentile(floors, 95))
    danger_lo = float(np.percentile(dangers, 5))
    separation = danger_lo / max(floor_hi, 1e-6)
    if separation <= 1.5:
        thr = 0.0  # no safe margin — leave early stop disabled
    else:
        thr = float(np.sqrt(max(floor_hi, 1e-6) * danger_lo))
    return {"threshold": thr, "floor_p95": floor_hi,
            "danger_p05": danger_lo, "separation": separation,
            "n_utterances": len(floors)}


def stop_statistics_from_decodes(mels: Iterable[np.ndarray],
                                 boundaries: Iterable[int], r: int = 2,
                                 guard: int = 20) -> Dict[str, float]:
    """Calibrate from the TRAINED MODEL's own free-running decodes.

    The corpus-trailing-frame statistic above assumes utterances end in
    recorded silence — but the feature pipeline TRIMS trailing silence
    (dsp.trim_wav, mirroring the reference), so on a tightly-trimmed
    corpus the last frames are speech and :func:`stop_statistics`
    correctly reports "no safe threshold" without ever seeing what the
    decoder emits after speech. What the decoder emits post-speech is
    learned from the feeder's zero PADDING frames (trained with full-
    length loss, reference helpers.py:51-53) — so the decisive statistic
    comes from decodes themselves:

    * ``mels`` — free-running decoded mels [S*r, M] that ran to the step
      budget (no early stop; threshold 0 while calibrating);
    * ``boundaries`` — per decode, the frame index where the audio
      endpoint detector places end-of-speech
      (``dsp.find_endpoint(wav) / hop_samples``).

    floor = the decoder's post-speech emission level (window-max peaks
    beyond boundary+guard); danger = its quietest mid-speech r-step
    (window-max peaks before boundary-guard). Same recommendation rule
    as the corpus variant.

    ``guard`` must cover the endpoint detector's overhang: find_endpoint
    cuts at ``hop`` (~0.2 s = 16 frames) INTO the first silent window,
    so the last ~16 "speech" frames are really silence onset — with a
    small guard they leak into the danger statistic and the calibration
    wrongly refuses (danger below floor). Default 20 frames.
    """
    floors: List[float] = []
    dangers: List[float] = []
    for mel, boundary in zip(mels, boundaries):
        mel = np.asarray(mel)
        peaks = mel.max(axis=1)
        b = int(boundary)
        post = peaks[min(b + guard, len(peaks)):]
        pre = peaks[: max(b - guard, 0)]
        if len(post) >= r:
            # the stop needs one full r-step below threshold; use the
            # QUIETEST post-speech step (the one that will fire)
            floors.append(float(sliding_window_max(post, r).min()))
        if len(pre) >= r:
            dangers.append(float(sliding_window_max(pre, r).min()))
    if not floors or not dangers:
        return {"threshold": 0.0, "floor_p95": float("nan"),
                "danger_p05": float("nan"), "separation": 0.0,
                "n_utterances": len(floors)}
    floor_hi = float(np.percentile(floors, 95))
    danger_lo = float(np.percentile(dangers, 5))
    separation = danger_lo / max(floor_hi, 1e-6)
    if separation <= 1.5:
        thr = 0.0
    else:
        thr = float(np.sqrt(max(floor_hi, 1e-6) * danger_lo))
    return {"threshold": thr, "floor_p95": floor_hi,
            "danger_p05": danger_lo, "separation": separation,
            "n_utterances": len(floors)}


def apply_threshold_to_run(ckpt_dir: str, threshold: float) -> str:
    """Persist the calibrated threshold into a run's ``config.json`` so
    every serving entry point (``Synthesizer.from_checkpoint``, the eval
    CLI, the demo server, streaming) picks it up with no flags."""
    import json
    import os

    from nspeech_tpu_torch.train.metadata import METADATA_FILE, load_run_metadata

    meta = load_run_metadata(ckpt_dir)
    if meta is None:
        raise FileNotFoundError(f"no run metadata in {ckpt_dir}")
    meta["hparams"]["stop_threshold"] = float(threshold)
    path = os.path.join(ckpt_dir, METADATA_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1, sort_keys=True, default=str)
    os.replace(tmp, path)
    return path
