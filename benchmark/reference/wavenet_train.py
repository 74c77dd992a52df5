"""Plain training of the mel-conditioned WaveNet vocoder (van den Oord et
al. 2016, arXiv:1609.03499; the mel conditioning of Shen et al. 2018,
arXiv:1712.05884) at the repo's recipe (``hparams/wavenet.yaml`` and
``train.yaml``, ``docs/vocoder/README.md``: lc 80, windows of the
receptive field + ``sample_size`` samples, batch 4): the windows cut
from the corpus, their codes and conditioning, the teacher-forced loss,
its gradients by autograd and the clipped Adam step with the Noam
schedule.

- Windows: each WAV read as int16 / 32768, trimmed by frame RMS (frames
  of 2048 samples, hop 512, centred on zeros; the first frame above
  ``silence_threshold`` to the last, each at frame index x 512), padded
  on the left by the receptive field with zeros and cut at every
  ``sample_size`` samples while more than a window remains. The mel of
  the padded utterance (``dsp.featurize``) gives each window the rows from
  the one at or before its start, edge-held past the end, and the phase,
  the window's start less that row's anchor.
- Codes: mu-law, ``q`` levels: the code of x is the largest q whose lower
  boundary, the expansion of the companded half step (2q - 1) / (q - 1)
  - 1, lies at or below x, in float64 (the levels themselves are
  ``dsp.mu_law_table``'s).
- Loss: the codes of a window but its last are the input, its samples
  but the first receptive field are scored: the logits of sample t + 1
  are :func:`reference.wavenet.logits` at t, with the mel upsampled to
  samples as ``dsp.upsample`` does (frame k at sample k x hop) from the
  window's phase. Only positions whose whole receptive field lies in the
  window are scored, so no zero state before the window is seen. The
  mean cross-entropy over every scored sample of the batch, plus
  ``l2_regularization_strength`` x half the sum of squares of every
  weight when it is set.
- Step: the gradient clipped to global norm 1 when its norm reaches 1,
  Adam (beta1, beta2 of the recipe, eps 1e-8, bias corrections 1 -
  beta^t), the Noam schedule (warm-up 4,000 steps) of
  ``initial_learning_rate``, a constant rate when ``decay_learning_rate``
  is off.

Departures from the papers, all the recipe's: a softmax over 256 mu-law
levels (as van den Oord et al.; not Shen et al.'s mixture of logistics
over 16-bit samples), frame-rate mels upsampled by linear interpolation
(not learned transposed convolutions), no biases, no speaker
conditioning, a 20,480-sample window.

``reference.wavenet.logits`` serves without autograd; its undecorated
body (``__wrapped__``) is what this file differentiates, in the
parameters' dtype (float32 on the card, float64 in the CPU tests). Plain
PyTorch and NumPy; nothing here imports the program.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from benchmark.reference import dsp as rdsp
from benchmark.reference import wavenet as rwavenet

WARMUP_STEPS = 4000.0
EPS = 1e-8
CLIP = 1.0


def receptive_field(cfg) -> int:
    return (cfg["filter_width"] - 1) * (sum(rwavenet.dilations(cfg)) + 1) + 1


# -- windows ------------------------------------------------------------------

def read_wav(path: str) -> np.ndarray:
    from scipy.io import wavfile
    _, pcm = wavfile.read(path)
    return pcm.astype(np.float32) / 32768.0


def trim(wav: np.ndarray, threshold: float, frame: int = 2048, hop: int = 512):
    """The span of frames whose RMS exceeds ``threshold`` (empty if none)."""
    frame = min(frame, max(len(wav), 1))
    padded = np.pad(wav, (frame // 2, frame // 2))
    n = 1 + (len(padded) - frame) // hop
    rms = np.array([np.sqrt(np.mean(padded[i * hop:i * hop + frame].astype(np.float64) ** 2))
                    for i in range(max(n, 0))])
    loud = np.nonzero(rms > threshold)[0]
    if loud.size == 0:
        return wav[:0]
    return wav[loud[0] * hop: loud[-1] * hop]


def utterance(cfg, path: str) -> np.ndarray:
    """The trimmed, left-padded waveform windows are cut from."""
    wav = trim(read_wav(path), cfg["silence_threshold"])
    return np.pad(wav, (receptive_field(cfg), 0))


def window_offsets(cfg, length: int):
    size = receptive_field(cfg) + cfg["sample_size"]
    return range(0, max(length - size, 0), cfg["sample_size"])


def key(window: np.ndarray) -> str:
    """A window's samples as a dictionary key."""
    return hashlib.sha1(np.ascontiguousarray(window, np.float32).tobytes()).hexdigest()


def rows_per_window(cfg) -> int:
    """Rows that cover a window's last sample and its upper neighbour at
    the largest phase (hop - 1)."""
    hop = rdsp.stft_params(cfg)[1]
    size = receptive_field(cfg) + cfg["sample_size"]
    return (size + hop - 2) // hop + 2


def window_rows(cfg, mel: np.ndarray, offset: int):
    """(mel rows [rows_per_window, M], phase) of the window at ``offset``."""
    hop, n = rdsp.stft_params(cfg)[1], rows_per_window(cfg)
    first = offset // hop
    rows = mel[first: first + n]
    if len(rows) < n:
        rows = np.concatenate([rows, np.repeat(rows[-1:], n - len(rows), 0)])
    return rows, offset - first * hop


# -- the loss -----------------------------------------------------------------

def mu_law_codes(x: torch.Tensor, q: int) -> torch.Tensor:
    mu = q - 1
    s = (2.0 * np.arange(1, q) - 1.0) / mu - 1.0
    bounds = np.sign(s) * ((1.0 + mu) ** np.abs(s) - 1.0) / mu
    return torch.searchsorted(torch.from_numpy(bounds).to(x.device),
                              x.double().contiguous(), right=True)


def conditioning(cfg, rows: torch.Tensor, phase: int, length: int) -> torch.Tensor:
    """The window's mel at each of its ``length`` samples."""
    hop = rdsp.stft_params(cfg)[1]
    return rdsp.upsample(rows, hop, int(phase) + length)[int(phase):]


class _OneHotIn(TorchFunctionMode):
    """``Tensor.float()`` (the one-hot input of ``reference.wavenet``) in
    the parameters' dtype."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float:
            return args[0].to(self.dtype)
        return func(*args, **(kwargs or {}))


def leaves(tree):
    """The tree's tensors, dictionary keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def row_loss_sum(cfg, params, audio: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    """The summed cross-entropy of one window's scored samples (audio [T],
    lc [T, M] per sample)."""
    rf = receptive_field(cfg)
    codes = mu_law_codes(audio, cfg["quantization_channels"])
    dtype = params["post2"].dtype
    with _OneHotIn(dtype):
        logits = rwavenet.logits.__wrapped__(cfg, params, codes[:-1], lc[:-1].to(dtype))
    return F.cross_entropy(logits[rf - 1:], codes[rf:], reduction="sum")


def grads(cfg, params, batch):
    """(loss, gradient leaves in :func:`leaves` order) of a batch: (audio
    [B, T], mel rows [B, R, M], phases [B]) on the parameters' device."""
    audio, rows, phase = batch
    flat = leaves(params)
    total = [torch.zeros_like(x) for x in flat]
    n = audio.shape[0] * (audio.shape[1] - receptive_field(cfg))
    loss = 0.0
    for x in flat:
        x.requires_grad_(True)
    for b in range(audio.shape[0]):         # a window at a time, to fit
        lc = conditioning(cfg, rows[b], phase[b], audio.shape[1])
        part = row_loss_sum(cfg, params, audio[b], lc) / n
        if b == 0 and cfg["l2_regularization_strength"]:
            part = part + cfg["l2_regularization_strength"] * 0.5 * sum(
                (x * x).sum() for x in flat)
        for t, g in zip(total, torch.autograd.grad(part, flat, allow_unused=True)):
            if g is not None:
                t += g
        loss += float(part.detach())
    for x in flat:
        x.requires_grad_(False)
    return loss, total


def learning_rate(cfg, step: int) -> float:
    lr = cfg["initial_learning_rate"]
    if not cfg["decay_learning_rate"]:
        return lr
    s = step + 1.0
    return lr * WARMUP_STEPS ** 0.5 * min(s * WARMUP_STEPS ** -1.5, s ** -0.5)


def train(cfg, params, batches):
    """Steps over ``batches`` from ``params`` (a tree, left as it is):
    (each step's loss, the first step's clipped gradient, the parameters
    after the last step), the tensors as lists in :func:`leaves` order."""
    flat = [x.detach().clone() for x in leaves(params)]
    tree = _rebuild(params, iter(flat))
    b1, b2 = cfg["adam"]["beta1"], cfg["adam"]["beta2"]
    mu = [torch.zeros_like(x) for x in flat]
    nu = [torch.zeros_like(x) for x in flat]
    losses, first = [], None
    for step, batch in enumerate(batches):
        loss, g = grads(cfg, tree, batch)
        losses.append(loss)
        with torch.no_grad():
            norm = torch.sqrt(sum((x * x).sum() for x in g))
            g = [x if norm < CLIP else x / norm * CLIP for x in g]
            if first is None:
                first = [x.clone() for x in g]
            lr = learning_rate(cfg, step)
            c1, c2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
            for j, (x, gj) in enumerate(zip(flat, g)):
                mu[j] = (1 - b1) * gj + b1 * mu[j]
                nu[j] = (1 - b2) * gj * gj + b2 * nu[j]
                x -= lr * (mu[j] / c1) / (torch.sqrt(nu[j] / c2) + EPS)
    return losses, first, flat


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)
