"""What the port's CUDA-graphed Tacotron step decides on the CPU
(``train/loop.py`` ``graph_key``, ``train/optim.py`` ``Adam``):

- Adam's update with its scalars (the negated learning rate and the two
  bias corrections) as 0-dim float32 tensors, as a graph reads them, is
  bit for bit the update with the Python floats of the eager step, at
  counts 1-6 (the bias corrections lose most of their digits near 1).
- When a step runs as a graph: a CUDA batch without ``dp`` or ``tp``.
  The CPU step and the data- and tensor-parallel steps stay eager, and
  the key of a graph changes with the padded shapes, ``deferred_dw``,
  the compute dtype, scheduled sampling and the generator, and with
  nothing else.
- The same for the WaveNet step (``wavenet_graph_key``): the CPU and
  data-parallel steps stay eager, and the key changes with the shapes
  of ``audio`` and ``mel``, whether there is a ``mel_phase`` and the
  compute dtype, and with nothing else (the conditioning, the L2 term
  and the EMA are fixed when the step is built).

The graphs themselves run on the card only: ``tests/test_torch_gpu.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.models import Tacotron2, WaveNet
from nspeech_tpu_torch.train.loop import (TacotronBatch, WaveNetDeviceBatch,
                                          graph_key, wavenet_graph_key)
from nspeech_tpu_torch.train.optim import Adam, exponential_halflife_schedule


def _tree(rng, scale=1.0):
    return {"a": torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32) * scale),
            "b": [torch.from_numpy(rng.standard_normal(11).astype(np.float32) * scale)]}


@pytest.mark.parametrize("count", range(1, 7))
def test_adam_with_device_scalars_is_bit_identical(count):
    """CPU tensors take ``Adam.update``'s ``torch.div`` branch; its CUDA
    branch (a product with the reciprocal, as PyTorch's CUDA kernels
    divide by a host scalar) is held to the eager step on the card alone,
    by ``tests/test_torch_gpu.py``'s graphed-against-eager tests."""
    rng = np.random.default_rng(count)
    opt = Adam(exponential_halflife_schedule(2e-3, 3.0), 0.9, 0.999)
    params = _tree(rng)
    state = opt.init(params)
    for _ in range(count - 1):      # moments of earlier steps
        _, state = opt.update(_tree(rng, 0.3), state)
    state_t = dict(state)
    grads = _tree(rng, 0.5)
    floats = opt.scalars(state["count"])
    scalars = tuple(torch.tensor(v, dtype=torch.float32) for v in floats)
    want, new = opt.update(grads, state, scalars=None)
    got, new_t = opt.update(grads, state_t, scalars=scalars)
    assert new["count"] == new_t["count"] == count
    for a, b in zip(*(sorted(tree_items(t)) for t in (want, got))):
        assert torch.equal(a[1], b[1]), a[0]
    for k in ("mu", "nu"):
        for a, b in zip(*(sorted(tree_items(t[k])) for t in (new, new_t))):
            assert torch.equal(a[1], b[1]), (k, a[0])
    # the float32 values the eager step multiplies and divides by
    assert all(float(np.float32(v)) == v for v in floats[1:])


def tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [i for k in tree for i in tree_items(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [i for n, v in enumerate(tree) for i in tree_items(v, f"{prefix}/{n}")]
    return [(prefix, tree)]


def _batch(device, n=4, t_in=32, t_out=100):
    """A batch's shapes and device, as ``graph_key`` reads them (a CUDA
    device needs no card to be named)."""
    def t(*shape):
        return SimpleNamespace(shape=shape, device=torch.device(device))
    return TacotronBatch(t(n, t_in), t(n), t(n), t(n, t_out, 80), t(n, t_out, 1025))


MODEL = Tacotron2(load_config("taco2"))
GEN = object()      # any generator: the key reads only whether there is one


@pytest.mark.parametrize("case,batch,kw", [
    ("cpu", _batch("cpu"), {}),
    ("data parallel", _batch("cuda"), {"dp": object()}),
    ("tensor parallel", _batch("cuda"), {"tp": object()}),
    ("data and tensor parallel", _batch("cuda"), {"dp": object(), "tp": object()}),
])
def test_eager_steps_take_no_graph(case, batch, kw):
    assert graph_key(MODEL, batch, GEN, True, **kw) is None, case


def test_cuda_step_keys_its_padded_shapes():
    key = graph_key(MODEL, _batch("cuda"), GEN, True)
    assert key[:3] == (4, 32, 100)
    assert graph_key(MODEL, _batch("cuda"), GEN, True) == key     # the same shape again
    assert graph_key(MODEL, _batch("cuda:0"), GEN, True) == key   # any index


@pytest.mark.parametrize("case,other", [
    ("another T_out", lambda: graph_key(MODEL, _batch("cuda", t_out=200), GEN, True)),
    ("another T_in", lambda: graph_key(MODEL, _batch("cuda", t_in=64), GEN, True)),
    ("another batch", lambda: graph_key(MODEL, _batch("cuda", n=8), GEN, True)),
    ("weight gradients from autograd",
     lambda: graph_key(MODEL, _batch("cuda"), GEN, False)),
    ("no generator", lambda: graph_key(MODEL, _batch("cuda"), None, True)),
    ("bf16 policy", lambda: graph_key(
        Tacotron2(load_config("taco2").parse("compute_dtype=bfloat16")),
        _batch("cuda"), GEN, True)),
    ("scheduled sampling", lambda: graph_key(
        Tacotron2(load_config("taco2").parse("scheduled_sampling_ratio=0.2")),
        _batch("cuda"), GEN, True)),
])
def test_what_changes_the_captured_work_changes_the_key(case, other):
    key = graph_key(MODEL, _batch("cuda"), GEN, True)
    assert other() not in (None, key), case


def _wn_batch(device, n=4, window=2048, frames=12, phase=True, per_sample=False):
    """A WaveNet batch's shapes and device, as ``wavenet_graph_key`` reads
    them: frame-rate mel rows with their phase, or per-sample rows (the
    GTA layout) without."""
    def t(*shape):
        return SimpleNamespace(shape=shape, device=torch.device(device))
    mel = t(n, window, 80) if per_sample else t(n, frames, 80)
    return WaveNetDeviceBatch(t(n, window), t(n), mel,
                              t(n) if phase and not per_sample else None)


def _vocoder(hparams=""):
    return WaveNet(load_config("wavenet").parse("lc_channels=80" + hparams))


VOCODER = _vocoder()


@pytest.mark.parametrize("case,batch,kw", [
    ("cpu", _wn_batch("cpu"), {}),
    ("cpu, per-sample mels", _wn_batch("cpu", per_sample=True), {}),
    ("data parallel", _wn_batch("cuda"), {"dp": object()}),
])
def test_eager_wavenet_steps_take_no_graph(case, batch, kw):
    assert wavenet_graph_key(VOCODER, batch, **kw) is None, case


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cuda:1"])
def test_cuda_wavenet_step_keys_its_shapes(device):
    key = wavenet_graph_key(VOCODER, _wn_batch("cuda"))
    assert key is not None
    assert wavenet_graph_key(VOCODER, _wn_batch(device)) == key


@pytest.mark.parametrize("case,other", [
    ("another window", lambda: _wn_batch("cuda", window=4096)),
    ("another batch", lambda: _wn_batch("cuda", n=8)),
    ("more mel rows", lambda: _wn_batch("cuda", frames=20)),
    ("no mel_phase", lambda: _wn_batch("cuda", phase=False)),
    ("per-sample mels", lambda: _wn_batch("cuda", per_sample=True)),
])
def test_what_changes_the_captured_wavenet_work_changes_the_key(case, other):
    key = wavenet_graph_key(VOCODER, _wn_batch("cuda"))
    assert wavenet_graph_key(VOCODER, other()) not in (None, key), case


def test_the_wavenet_key_changes_with_the_compute_dtype():
    key = wavenet_graph_key(VOCODER, _wn_batch("cuda"))
    bf16 = wavenet_graph_key(_vocoder(",compute_dtype=bfloat16"), _wn_batch("cuda"))
    assert bf16 not in (None, key)


@pytest.mark.parametrize("case,hparams", [
    ("gc conditioning", ",gc_channels=16,gc_category_cardinality=4"),
    ("an EMA", ",ema_decay=0.999"),
    ("an L2 term", ",l2_regularization_strength=0.001"),
    ("another batch size and window in the hparams", ",batch_size=8,sample_size=4096"),
])
def test_what_the_step_fixes_leaves_the_wavenet_key(case, hparams):
    key = wavenet_graph_key(VOCODER, _wn_batch("cuda"))
    assert wavenet_graph_key(_vocoder(hparams), _wn_batch("cuda")) == key, case
