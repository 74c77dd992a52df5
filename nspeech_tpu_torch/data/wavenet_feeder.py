"""Host-side WaveNet conditioning, from ``nspeech_tpu/data/wavenet_feeder.py``.

Only :func:`upsample_frames` so far: the generation CLI's ``--mel-npy``
route conditions on a saved mel through it. The training feeder waits for
the port's training.
"""

from __future__ import annotations

import numpy as np


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
