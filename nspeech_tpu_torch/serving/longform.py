"""Long-form synthesis: texts beyond the decoder's frame cap.

Port of ``nspeech_tpu/serving/longform.py``. A decode holds at most
``max_iters * outputs_per_step`` frames, so a long text is split at
sentence boundaries (then clauses, then words), the pieces are
synthesized as one padded batch, and the endpoint-trimmed pieces are
joined with short pauses.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

# Sentence-final punctuation (kept with the sentence).
_SENTENCE_END = re.compile(r"(?<=[.!?;])\s+")
_CLAUSE_END = re.compile(r"(?<=[,:])\s+")

# ~14 characters of cleaned English per second: the default decoder cap
# (300 steps of 5 frames at 12.5 ms) covers a 200-character piece.
DEFAULT_MAX_CHARS = 200


def split_text(text: str, max_chars: int = DEFAULT_MAX_CHARS) -> List[str]:
    """Split into synthesis pieces, each at most ``max_chars`` long:
    sentences first, then clauses, then word boundaries as a last resort.
    Never splits inside a word; pieces keep their punctuation."""
    pieces: List[str] = []
    for sentence in _SENTENCE_END.split(text.strip()):
        sentence = sentence.strip()
        if not sentence:
            continue
        if len(sentence) <= max_chars:
            pieces.append(sentence)
            continue
        for clause in _CLAUSE_END.split(sentence):
            clause = clause.strip()
            if len(clause) <= max_chars:
                if clause:
                    pieces.append(clause)
                continue
            cur = ""
            for w in clause.split():
                if cur and len(cur) + 1 + len(w) > max_chars:
                    pieces.append(cur)
                    cur = w
                else:
                    cur = (cur + " " + w) if cur else w
            if cur:
                pieces.append(cur)
    return pieces


def synthesize_long(synthesizer, text: str, speaker_id: int = -1,
                    sample_rate: Optional[int] = None, pause_ms: float = 150.0,
                    max_chars: int = DEFAULT_MAX_CHARS) -> np.ndarray:
    """Arbitrary-length text -> one waveform.

    ``synthesizer`` is anything with ``synthesize_batch(texts,
    speaker_ids) -> (wavs, mels, lins)`` (``Synthesizer``,
    ``TextToSpeech`` or a ``DynamicBatcher``). The pieces are synthesized
    as one batch and joined with ``pause_ms`` of silence."""
    pieces = split_text(text, max_chars)
    if not pieces:
        raise ValueError("no synthesizable text")
    rate = sample_rate or getattr(getattr(synthesizer, "cfg", None),
                                  "sample_rate", None)
    if rate is None:
        raise ValueError("pass sample_rate= (synthesizer has no cfg)")
    wavs, _mels, _lins = synthesizer.synthesize_batch(
        pieces, [speaker_id] * len(pieces))
    gap = np.zeros(int(rate * pause_ms / 1000.0), np.float32)
    joined: List[np.ndarray] = []
    for i, wav in enumerate(wavs):
        if i:
            joined.append(gap)
        joined.append(np.asarray(wav, np.float32))
    return np.concatenate(joined)
