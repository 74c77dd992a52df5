"""What the port's train step core decides on the CPU (``train/loop.py``
``build_train_step``, ``shape_key``; ``train/optim.py`` ``Adam``):

- Adam's update, whose scalars (the negated learning rate and the two
  bias corrections) are always 0-dim tensors, is bit for bit optax's
  formula written with the Python floats of ``Adam.scalars``, at counts
  1-6 (the bias corrections lose most of their digits near 1), for
  float32 and float64 moments.
- When a step runs as a graph: a CUDA batch, in a step built without
  ``dp`` or ``tp``. The CPU step, the data- and tensor-parallel steps and
  the time-sharded vocoder step stay eager.
- The graph's key is the batch's field shapes and whether there is a
  generator; what changes a shape, a field or the generator changes it.
- Under each setting that the step fixes when it is built (deferred or
  autograd weight gradients, bf16, scheduled sampling, an EMA, gc, the
  L2 term, the hparams' batch size), the built step's state and metrics
  equal, bit for bit, the composition by hand of the model's gradient
  function, ``Adam.update`` with the same norm, ``apply_updates`` and
  ``ema_update``.

The graphs themselves run on the card only: ``tests/test_torch_gpu.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nspeech_tpu_torch.config import load_config, stft_params
from nspeech_tpu_torch.data.feeder import Batch
from nspeech_tpu_torch.data.wavenet_feeder import WaveNetBatch
from nspeech_tpu_torch.models import Tacotron1, Tacotron2, WaveNet
from nspeech_tpu_torch.parallel.timeshard import build_time_sharded_wavenet_step
from nspeech_tpu_torch.train.loop import (CudaGraphSteps, TacotronBatch, TrainState,
                                          WaveNetDeviceBatch, batch_to_device,
                                          build_tacotron_train_step,
                                          build_wavenet_train_step, create_state,
                                          ema_update, grad_norms, shape_key,
                                          step_generator, tacotron_grads,
                                          wavenet_batch_to_device, wavenet_grads)
from nspeech_tpu_torch.train.optim import (Adam, apply_updates,
                                           exponential_halflife_schedule, global_norm,
                                           make_optimizer)
from nspeech_tpu_torch.utils.tree import tree_map


def _tree(rng, dtype, scale=1.0):
    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)
    return {"a": leaf(7, 5), "b": [leaf(11)]}


def tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [i for k in tree for i in tree_items(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [i for n, v in enumerate(tree) for i in tree_items(v, f"{prefix}/{n}")]
    return [(prefix, tree)]


def assert_trees_equal(a, b, what=""):
    items_a, items_b = tree_items(a), tree_items(b)
    assert [k for k, _ in items_a] == [k for k, _ in items_b], what
    for (k, x), (_, y) in zip(items_a, items_b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}{k}"
        else:
            assert x == y, f"{what}{k}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("count", range(1, 7))
def test_adam_update_is_optax_with_python_floats(count, dtype):
    """CPU tensors divide by the 0-dim scalars; on CUDA ``Adam.update``
    multiplies by their reciprocals, as PyTorch's CUDA kernels divide by
    a host scalar: held to the eager step on the card alone, by
    ``tests/test_torch_gpu.py``'s graphed-against-eager tests."""
    rng = np.random.default_rng(count)
    opt = Adam(exponential_halflife_schedule(2e-3, 3.0), 0.9, 0.999)
    state = opt.init(_tree(rng, dtype))
    for _ in range(count - 1):      # moments of earlier steps
        _, state = opt.update(_tree(rng, dtype, 0.3), state)
    grads = _tree(rng, dtype, 0.5)  # global norm ~3.4: clipped
    got, new = opt.update(grads, state)
    assert new["count"] == count
    lr, c1, c2 = opt.scalars(state["count"])
    # the float32 values the update multiplies and divides by
    assert all(float(np.float32(v)) == v for v in (c1, c2))
    norm = global_norm(grads)
    g = tree_map(lambda t: torch.where(norm < 1.0, t, t / norm * 1.0), grads)
    mu = tree_map(lambda t, m: (1 - 0.9) * t + 0.9 * m, g, state["mu"])
    nu = tree_map(lambda t, v: (1 - 0.999) * t * t + 0.999 * v, g, state["nu"])
    want = tree_map(lambda m, v: lr * ((m / c1) / (torch.sqrt(v / c2) + 1e-8)), mu, nu)
    assert_trees_equal(got, want, "update")
    assert_trees_equal((new["mu"], new["nu"]), (mu, nu), "moments")


def _batch(device, n=4, t_in=32, t_out=100):
    """A batch's shapes and device, as the step's decision and
    ``shape_key`` read them (a CUDA device needs no card to be named)."""
    def t(*shape):
        return SimpleNamespace(shape=shape, device=torch.device(device))
    return TacotronBatch(t(n, t_in), t(n), t(n), t(n, t_out, 80), t(n, t_out, 1025))


def _wn_batch(device, n=4, window=2048, frames=12, phase=True, per_sample=False):
    """A WaveNet batch's shapes and device: frame-rate mel rows with their
    phase, or per-sample rows (the GTA layout) without."""
    def t(*shape):
        return SimpleNamespace(shape=shape, device=torch.device(device))
    mel = t(n, window, 80) if per_sample else t(n, frames, 80)
    return WaveNetDeviceBatch(t(n, window), t(n), mel,
                              t(n) if phase and not per_sample else None)


MODEL = Tacotron2(load_config("taco2"))
VOCODER = WaveNet(load_config("wavenet").parse("lc_channels=80"))
OPT = Adam(lambda step: 1e-3, 0.9, 0.999)
GEN = object()      # any generator: the key reads only whether there is one


def _taco(**kw):
    return build_tacotron_train_step(MODEL, OPT, **kw)


def _vocoder(**kw):
    return build_wavenet_train_step(VOCODER, OPT, VOCODER.cfg, use_lc=True, **kw)


def _time_sharded():
    return build_time_sharded_wavenet_step(VOCODER, OPT, SimpleNamespace(rank=0, world=2))


@pytest.mark.parametrize("case,build,batch,graphed", [
    ("tacotron, cpu", _taco, _batch("cpu"), False),
    ("tacotron, data parallel", lambda: _taco(dp=object()), _batch("cuda"), False),
    ("tacotron, tensor parallel", lambda: _taco(tp=object()), _batch("cuda"), False),
    ("tacotron, data and tensor parallel",
     lambda: _taco(dp=object(), tp=object()), _batch("cuda"), False),
    ("tacotron, cuda", _taco, _batch("cuda"), True),
    ("wavenet, cpu", _vocoder, _wn_batch("cpu"), False),
    ("wavenet, cpu, per-sample mels", _vocoder, _wn_batch("cpu", per_sample=True), False),
    ("wavenet, data parallel", lambda: _vocoder(dp=object()), _wn_batch("cuda"), False),
    ("wavenet, cuda", _vocoder, _wn_batch("cuda"), True),
    ("time-sharded wavenet, cuda", _time_sharded, _wn_batch("cuda"), False),
])
def test_only_a_cuda_batch_without_dp_or_tp_takes_a_graph(case, build, batch, graphed,
                                                          monkeypatch):
    step = build()
    taken = []
    step.graphs.step = lambda state, b, generator: (taken.append("eager"), (state, {}))[1]
    monkeypatch.setattr(CudaGraphSteps, "__call__", lambda self, state, b, generator: (
        taken.append("graph"), (state, {}))[1])
    step(TrainState(0, {}, {}, {}), batch, GEN)
    assert taken == ["graph" if graphed else "eager"], case


@pytest.mark.parametrize("device", ["cuda:0", "cuda:1"])
@pytest.mark.parametrize("batch,shapes", [
    (_batch, ((4, 32), (4,), (4,), (4, 100, 80), (4, 100, 1025))),
    (_wn_batch, ((4, 2048), (4,), (4, 12, 80), (4,))),
], ids=["tacotron", "wavenet"])
def test_the_key_holds_the_batchs_shapes(batch, shapes, device):
    key = shape_key(batch("cuda"), GEN)
    assert key == (shapes, True)
    assert shape_key(batch(device), GEN) == key       # the same shape, any index


@pytest.mark.parametrize("case,base,other", [
    ("another T_out", _batch("cuda"), (_batch("cuda", t_out=200), GEN)),
    ("another T_in", _batch("cuda"), (_batch("cuda", t_in=64), GEN)),
    ("another batch", _batch("cuda"), (_batch("cuda", n=8), GEN)),
    ("no generator", _batch("cuda"), (_batch("cuda"), None)),
    ("another window", _wn_batch("cuda"), (_wn_batch("cuda", window=4096), GEN)),
    ("another vocoder batch", _wn_batch("cuda"), (_wn_batch("cuda", n=8), GEN)),
    ("more mel rows", _wn_batch("cuda"), (_wn_batch("cuda", frames=20), GEN)),
    ("no mel_phase", _wn_batch("cuda"), (_wn_batch("cuda", phase=False), GEN)),
    ("per-sample mels", _wn_batch("cuda"), (_wn_batch("cuda", per_sample=True), GEN)),
])
def test_what_changes_a_batch_or_the_generator_changes_the_key(case, base, other):
    assert shape_key(*other) != shape_key(base, GEN), case


# -- the built step against the composition by hand -----------------------------

TINY_T2 = ("encoder_conv_layers=1,postnet_conv_layers=1,expand_conv_layers=1,"
           "encoder_conv_channels=16,attention_dim=16,postnet_conv_channels=16,"
           "expand_conv_channels=16,decoder_lstm_units=16,encoder_lstm_units=8,"
           "expand_lstm_units=8,embedding_dim=16,ema_decay=0")
TINY_T1 = ("encoder_cbhg_banks=2,post_cbhg_banks=2,attention_dim=16,decoder_dim=16,"
           "embedding_dim=16,ema_decay=0")
TINY_WN = ("dilations_length=3,dilations_depth=2,residual_channels=8,"
           "dilation_channels=8,skip_channels=16,quantization_channels=64,"
           "lc_channels=5,gc_channels=0,ema_decay=0,l2_regularization_strength=0,"
           "batch_size=2,sample_size=64")


def _tacotron_setup(name, extra, deferred_dw):
    cfg = load_config(name).parse({"taco1": TINY_T1, "taco2": TINY_T2}[name] + extra)
    model = {"taco1": Tacotron1, "taco2": Tacotron2}[name](cfg)
    opt, sched = make_optimizer(cfg, name)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        t_in, t_out, rows = 10, 20, 2
        ids = rng.integers(2, 40, (rows, t_in))
        batches.append(batch_to_device(Batch(
            ids, np.full(rows, t_in), np.zeros(rows, np.int64),
            rng.random((rows, t_out, cfg.num_mels), dtype=np.float32),
            rng.random((rows, t_out, cfg.num_freq), dtype=np.float32),
            np.zeros((rows, 0), np.float32)), "cpu"))
    step = build_tacotron_train_step(model, opt, sched, cfg.ema_decay, deferred_dw)
    deferred = hasattr(model, "deferred_zero_inputs") if deferred_dw is None else deferred_dw

    def grads_fn(state, batch, generator):
        return tacotron_grads(model, state, batch, generator, deferred)
    return cfg, model, opt, sched, batches, step, grads_fn


def _wavenet_setup(extra, per_sample, use_gc):
    """Two batches of 2 windows of the receptive field + 64 samples, and
    the step built from the config with ``extra``."""
    cfg = load_config("wavenet").parse(TINY_WN + extra)
    net = WaveNet(cfg)
    opt, sched = make_optimizer(cfg, "wavenet")
    rng = np.random.default_rng(6)
    rows, window, hop = 2, net.receptive_field + 64, stft_params(cfg)[1]
    batches = []
    for _ in range(2):
        if per_sample:
            mel, phase = rng.random((rows, window, 5), dtype=np.float32), None
        else:
            mel = rng.random((rows, (window + hop - 2) // hop + 2, 5), dtype=np.float32)
            phase = rng.integers(0, hop, rows).astype(np.int32)
        batches.append(wavenet_batch_to_device(WaveNetBatch(
            rng.uniform(-0.9, 0.9, (rows, window)).astype(np.float32),
            rng.integers(0, max(1, cfg.gc_category_cardinality), rows).astype(np.int32),
            mel, phase), "cpu"))
    l2 = cfg.l2_regularization_strength or None
    step = build_wavenet_train_step(net, opt, cfg, sched, use_gc, True, l2, cfg.ema_decay)

    def grads_fn(state, batch, generator):
        grads, metrics = wavenet_grads(net, state.params, batch, cfg, use_gc, True, l2)
        return grads, metrics, state.bn_state
    return cfg, net, opt, sched, batches, step, grads_fn


def _by_hand(grads_fn, opt, sched, ema_decay, state, batch, generator):
    grads, metrics, new_bn = grads_fn(state, batch, generator)
    with torch.no_grad():
        norm, norms = grad_norms(grads)
        updates, new_opt = opt.update(grads, state.opt_state, norm)
        params = apply_updates(state.params, updates)
        metrics.update(grad_norm=norm, grad_norms=norms,
                       learning_rate=float(sched(state.step)))
        return TrainState(state.step + 1, params, new_bn, new_opt,
                          ema_update(state.ema_params, params, ema_decay)), metrics


@pytest.mark.parametrize("case,setup", [
    ("taco2, deferred weight gradients", lambda: _tacotron_setup("taco2", "", None)),
    ("taco2, weight gradients from autograd",
     lambda: _tacotron_setup("taco2", "", False)),
    ("taco2, bf16", lambda: _tacotron_setup("taco2", ",compute_dtype=bfloat16", None)),
    ("taco2, scheduled sampling",
     lambda: _tacotron_setup("taco2", ",scheduled_sampling_ratio=0.5", None)),
    ("taco2, an EMA", lambda: _tacotron_setup("taco2", ",ema_decay=0.9", None)),
    ("taco1", lambda: _tacotron_setup("taco1", "", None)),
    ("wavenet, frame-rate mels", lambda: _wavenet_setup("", False, False)),
    ("wavenet, per-sample mels", lambda: _wavenet_setup("", True, False)),
    ("wavenet, gc", lambda: _wavenet_setup(",gc_channels=4,gc_category_cardinality=3",
                                           False, True)),
    ("wavenet, an EMA", lambda: _wavenet_setup(",ema_decay=0.9", False, False)),
    ("wavenet, an L2 term",
     lambda: _wavenet_setup(",l2_regularization_strength=0.01", False, False)),
    ("wavenet, another batch size and window in the hparams",
     lambda: _wavenet_setup(",batch_size=8,sample_size=4096", False, False)),
])
def test_step_is_the_composition_by_hand(case, setup):
    cfg, model, opt, sched, batches, step, grads_fn = setup()
    ema = bool(cfg.ema_decay)
    built = create_state(model, opt, 0, ema=ema)
    hand = create_state(model, opt, 0, ema=ema)
    for k, batch in enumerate(batches):
        built, got = step(built, batch, step_generator("cpu", 7, k))
        hand, want = _by_hand(grads_fn, opt, sched, cfg.ema_decay, hand, batch,
                              step_generator("cpu", 7, k))
        assert_trees_equal(got, want, f"{case}, step {k} metrics")
        assert_trees_equal(tuple(built), tuple(hand), f"{case}, step {k} state")
    assert built.step == 2 and built.opt_state["count"] == 2
    if ema:
        assert not torch.equal(tree_items(built.ema_params)[0][1],
                               tree_items(built.params)[0][1])
