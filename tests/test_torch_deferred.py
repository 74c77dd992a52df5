"""Deferred weight gradients in the port (``nspeech_tpu_torch/ops/deferred.py``)
on the CPU, at tiny widths.

- Each deferred op (dense, LSTM cell, GRU cell in a loop, the one-loop
  BiLSTM with lengths) against its plain form in float64: the post-hoc
  weight gradients and autograd's gradients of everything else within
  1e-12 of each leaf's largest entry; the weights the loop read detached
  get no gradient from autograd at all (no per-step weight gradient is
  formed).
- ``matmul_grads`` and ``bilstm_wh_grads`` against the JAX package's on
  the same stacked inputs (float32, 1e-5 relative).
- Both Tacotrons' training gradients with ``deferred_dw`` on against
  autograd's (``deferred_dw=False``) in float64, dropout and scheduled
  sampling drawn from the same generator: per leaf within 1e-10 of its
  largest entry.
- A float32 gradient with ``deferred_dw`` on against JAX's default
  (deferred) train step, with the bounds of ``tests/test_torch_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nspeech_tpu.ops import deferred as JDF
from nspeech_tpu.data.feeder import DataFeeder as JFeeder
from nspeech_tpu.train import loop as jloop
from nspeech_tpu.train.optim import make_optimizer as j_make_optimizer
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.ops import deferred as DF
from nspeech_tpu_torch.ops import layers as L
from nspeech_tpu_torch.train import loop as tloop
from nspeech_tpu_torch.utils.tree import named_leaves, tree_leaves, tree_map

from tests.make_synth_corpus import make_corpus
from tests.test_torch_train_step import (TINY, capture, configs, models,
                                         t_batch, t_state)

torch.set_num_threads(1)

F64 = torch.float64
OP_TOL = 1e-12
STEP_TOL = 1e-10


def rand(rng, *shape):
    return torch.tensor(rng.standard_normal(shape), dtype=F64)


def to64(tree):
    return tree_map(lambda t: t.to(F64) if t.is_floating_point() else t, tree)


def trainable(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def assert_leaves_close(got: dict, want: dict, tol: float):
    assert got.keys() == want.keys()
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max())
        assert err <= tol * max(scale, 1e-300), (k, err, scale)


def loop(cell, xs, state):
    """A loss over a recurrence of ``cell`` through the steps of ``xs``."""
    outs = []
    for x in xs:
        out, state = cell(x, state)
        outs.append(out)
    y = torch.stack(outs)
    return (torch.sin(y) * y).sum()


def run_op(kind, params, xs, taps=None):
    """The loss of one op in a loop, plain (``taps`` None) or deferred."""
    if kind == "dense":
        def cell(x, h):
            y = (L.dense(params, torch.cat([x, h], -1), torch.tanh) if taps is None
                 else DF.dense_deferred(params, torch.cat([x, h], -1), taps, "w",
                                        torch.tanh))
            return y, y
        return loop(cell, xs, xs.new_zeros(xs.shape[1], 4))
    if kind == "lstm":
        def cell(x, s):
            return (L.lstm_cell(params, x, s) if taps is None
                    else DF.lstm_cell_deferred(params, x, s, taps, "w"))
        z = xs.new_zeros(xs.shape[1], 4)
        return loop(cell, xs, (z, z))
    def cell(x, h):
        h = (L.gru_cell(params, x, h) if taps is None
             else DF.gru_cell_deferred(params, x, h, taps, "w"))
        return h, h
    return loop(cell, xs, xs.new_zeros(xs.shape[1], 4))


@pytest.mark.parametrize("kind", ["dense", "lstm", "gru"])
def test_deferred_cell_matches_plain_float64(kind):
    S, B, C, H = 7, 3, 5, 4
    rng = np.random.default_rng(0)
    init = {"dense": lambda: L.init_dense(rng, C + H, H),
            "lstm": lambda: L.init_lstm(rng, C, H),
            "gru": lambda: L.init_gru(rng, C, H)}[kind]
    params = trainable(to64(init()))
    xs = rand(rng, S, B, C).requires_grad_(True)
    names = sorted(params)
    want = torch.autograd.grad(run_op(kind, params, xs),
                               [params[k] for k in names] + [xs])
    shapes = ({"w_gate": (S, B, 2 * H), "w_cand": (S, B, H)} if kind == "gru"
              else {"w": (S, B, 4 * H if kind == "lstm" else H)})
    taps = DF.Taps(shapes)
    loss = run_op(kind, params, xs, taps)
    got = torch.autograd.grad(loss, [params[k] for k in names] + [xs],
                              allow_unused=True)
    assert all(g is None for g in got[:-1])       # no in-loop weight gradient
    post = {}
    for name in shapes:
        if kind == "gru":
            part = name.split("_")[1]
            post.update(DF.matmul_grads(*taps.stacked(name), f"{part}_kernel",
                                        f"{part}_bias"))
        else:
            post.update(DF.matmul_grads(*taps.stacked(name)))
    assert_leaves_close({**post, "x": got[-1]},
                        {**dict(zip(names, want[:-1])), "x": want[-1]}, OP_TOL)


def test_deferred_bilstm_matches_plain_float64():
    N, T, C, H = 3, 9, 5, 4
    rng = np.random.default_rng(1)
    pf, pb = (trainable(to64(L.init_lstm(rng, C, H))) for _ in range(2))
    x = rand(rng, N, T, C).requires_grad_(True)
    lengths = torch.tensor([9, 4, 6])
    leaves = [pf["kernel"], pf["bias"], pb["kernel"], pb["bias"], x]

    def loss(taps=None):
        y = L.bilstm_rnn(pf, pb, x, lengths, H, taps=taps, name="lstm")
        return (torch.sin(y) * y).sum()

    want = torch.autograd.grad(loss(), leaves)
    taps = DF.Taps({"lstm": (T, 2 * N, 4 * H)})
    got = list(torch.autograd.grad(loss(taps), leaves))
    dwh_fw, dwh_bw = DF.bilstm_wh_grads(*taps.stacked("lstm"))
    assert float(got[0][C:].abs().max()) == 0.0    # recurrent rows: deferred
    got[0][C:] = dwh_fw
    got[2][C:] = dwh_bw
    names = ["fw_kernel", "fw_bias", "bw_kernel", "bw_bias", "x"]
    assert_leaves_close(dict(zip(names, got)), dict(zip(names, want)), OP_TOL)


def test_post_hoc_products_match_jax():
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((6, 3, 5)).astype(np.float32)
    dz = rng.standard_normal((6, 3, 8)).astype(np.float32)
    j = JDF.matmul_grads(jnp.asarray(xs), jnp.asarray(dz))
    t = DF.matmul_grads(torch.from_numpy(xs), torch.from_numpy(dz))
    h = rng.standard_normal((7, 6, 4)).astype(np.float32)
    dzh = rng.standard_normal((7, 6, 16)).astype(np.float32)
    jh = JDF.bilstm_wh_grads(jnp.asarray(h), jnp.asarray(dzh))
    th = DF.bilstm_wh_grads(torch.from_numpy(h), torch.from_numpy(dzh))
    pairs = [(t["kernel"], j["kernel"]), (t["bias"], j["bias"]),
             (th[0], jh[0]), (th[1], jh[1])]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("name,extra", [
    ("taco2", ""), ("taco2", "scheduled_sampling_ratio=0.5"),
    ("taco2", "guided_attention_weight=0.5"), ("taco1", ""),
    ("taco1", "scheduled_sampling_ratio=0.5"),
])
def test_deferred_step_gradients_equal_autograd_float64(name, extra):
    cfg = load_config(name).parse(",".join(x for x in (TINY[name], extra) if x))
    model = create_model(name, cfg)
    params, bn = model.init(0)
    rng = np.random.default_rng(3)
    B, T_in, T_out = 3, 11, 20
    batch = tloop.TacotronBatch(
        torch.tensor(rng.integers(1, 30, (B, T_in))), torch.tensor([11, 6, 9]),
        torch.zeros(B, dtype=torch.int64),
        torch.tensor(rng.random((B, T_out, cfg.num_mels)), dtype=F64),
        torch.tensor(rng.random((B, T_out, cfg.num_freq)), dtype=F64))
    state = tloop.TrainState(0, to64(params), to64(bn), None)
    grads, losses = {}, {}
    torch.set_default_dtype(F64)                    # the decoder's zero carries
    try:
        for deferred in (False, True):
            gen = torch.Generator().manual_seed(5)  # the same dropout draws
            g, metrics, _ = tloop.tacotron_grads(model, state, batch, gen,
                                                 deferred_dw=deferred)
            grads[deferred] = dict(named_leaves(g))
            losses[deferred] = float(metrics["loss"])
    finally:
        torch.set_default_dtype(torch.float32)
    assert losses[True] == losses[False]             # one forward's values
    assert all(v.dtype == F64 for v in grads[True].values())
    assert_leaves_close(grads[True], grads[False], STEP_TOL)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    corpus = make_corpus(str(tmp_path_factory.mktemp("corpus")), n=6)
    jc, _ = configs("taco2")
    return next(JFeeder({"ljspeech": corpus}, jc, seed=0).epoch_batches(0))


@pytest.mark.parametrize("name", ["taco2", "taco1"])
def test_deferred_float32_gradients_match_jax_default_step(batch, name):
    """The bounds of ``test_torch_train_step``'s gradient check: per leaf
    1e-4 of its largest value, a batch-normed conv bias 1e-6 absolute."""
    jm, jp, js, tm, tp, ts = models(name)
    jc, tc = configs(name)
    jtx, jsched = j_make_optimizer(jc, name)
    jstep = jloop.build_tacotron_train_step(jm, capture(jtx), schedule=jsched)
    jstate = jloop.TrainState(jnp.zeros((), jnp.int32), jp, js,
                              capture(jtx).init(jp))
    tstate, _, _ = t_state(tm, tp, ts, tc, name)
    tgrads, tmet, _ = tloop.tacotron_grads(tm, tstate, t_batch(batch), None,
                                           deferred_dw=True)
    jstate, jmet = jstep(jstate, batch, jax.random.PRNGKey(1))
    jgrads = jax.tree_util.tree_leaves_with_path(jstate.opt_state[0]["g"])
    tleaves = tree_leaves(tgrads)
    assert len(jgrads) == len(tleaves)
    for (path, j), t in zip(jgrads, tleaves):
        j = np.asarray(j)
        bound = 1e-4 * np.abs(j).max()
        if jax.tree_util.keystr(path).endswith("['conv']['bias']"):
            bound = max(bound, 1e-6)
        err = np.abs(t.numpy() - j).max()
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * abs(float(jmet["loss"]))
