"""Training metrics as JSON lines: port of ``nspeech_tpu/utils/metrics.py``
without its TensorBoard channel (the card's machine has no TensorFlow).

``<log_dir>/metrics.jsonl`` gets one record per call: ``step``, ``time``
and the scalars, or, for histograms, each array's mean, std, min and max,
the same records the JAX package writes. :meth:`MetricWriter.audio` writes
nothing, as the JAX package's does without TensorFlow: the wav file on
disk is the copy.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def _write(self, rec: dict) -> None:
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._write(rec)

    def histograms(self, step: int, arrays: Dict[str, object]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in arrays.items():
            a = np.asarray(v, dtype=np.float32).ravel()
            if a.size == 0:
                continue
            rec[k + "/mean"] = float(a.mean())
            rec[k + "/std"] = float(a.std())
            rec[k + "/min"] = float(a.min())
            rec[k + "/max"] = float(a.max())
        self._write(rec)

    def audio(self, step: int, tag: str, wav, sample_rate: int) -> None:
        """The JAX package's TensorBoard audio summary: a no-op here."""

    def close(self) -> None:
        self._jsonl.close()
