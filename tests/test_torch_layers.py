"""The port's Tacotron layers against the JAX package's: the LSTM cell,
the length-masked BiLSTM, conv + batch norm, one location-sensitive
attention step (Tacotron-2); the highway, the GRU cell, the length-masked
GRU and BiGRU, the CBHG and one step of each of the six attention types
(Tacotron-1). Tolerance 1e-5 (float32, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nspeech_tpu.models import attention as JA
from nspeech_tpu.ops import layers as JL
from nspeech_tpu_torch.models import attention as TA
from nspeech_tpu_torch.ops import layers as TL

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def tree_t(tree):
    return jax.tree_util.tree_map(t, tree)


def test_lstm_cell_matches():
    rng = np.random.default_rng(0)
    p = JL.init_lstm(jax.random.PRNGKey(0), 6, 5)
    p["bias"] = jnp.asarray(rng.standard_normal(20).astype(np.float32))
    x = rng.standard_normal((3, 6)).astype(np.float32)
    c, h = (rng.standard_normal((3, 5)).astype(np.float32) for _ in range(2))
    jo, (jc, jh) = JL.lstm_cell(p, jnp.asarray(x), (jnp.asarray(c), jnp.asarray(h)))
    to, (tc, th) = TL.lstm_cell(tree_t(p), t(x), (t(c), t(h)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("lengths", [None, [7, 3, 0, 5]])
def test_bilstm_with_lengths_matches(lengths):
    rng = np.random.default_rng(1)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    pf, pb = JL.init_lstm(k1, 4, 6), JL.init_lstm(k2, 4, 6)
    x = rng.standard_normal((4, 7, 4)).astype(np.float32)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)
    j = np.asarray(JL.bilstm_rnn(pf, pb, jnp.asarray(x), jl, 6))
    out = TL.bilstm_rnn(tree_t(pf), tree_t(pb), t(x), tl, 6).numpy()
    assert out.shape == (4, 7, 12)
    np.testing.assert_allclose(out, j, **TOL)
    if lengths is not None:
        assert not out[1, 3:].any() and not out[2].any()


@pytest.mark.parametrize("width,act", [(5, "relu"), (7, None), (5, "tanh")])
def test_conv_bn_matches(width, act):
    rng = np.random.default_rng(width)
    p, s = JL.init_conv_bn(jax.random.PRNGKey(2), width, 6, 8)
    p["bn"]["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    p["bn"]["offset"] = jnp.asarray(rng.standard_normal(8).astype(np.float32))
    p["conv"]["bias"] = jnp.asarray(rng.standard_normal(8).astype(np.float32))
    s["bn"]["mean"] = jnp.asarray(rng.standard_normal(8).astype(np.float32))
    s["bn"]["var"] = jnp.asarray(rng.uniform(0.2, 2.0, 8).astype(np.float32))
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    jact = {"relu": jax.nn.relu, "tanh": jnp.tanh, None: None}[act]
    tact = {"relu": torch.relu, "tanh": torch.tanh, None: None}[act]
    j, _ = JL.conv_bn(p, s, jnp.asarray(x), jact, is_training=False)
    out = TL.conv_bn(tree_t(p), tree_t(s), t(x), tact)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("window", [False, True])
def test_location_attention_step_matches(window):
    rng = np.random.default_rng(3)
    N, T, U, D, Qd = 3, 9, 8, 10, 6
    p = JA.init_attention(jax.random.PRNGKey(3), "location_sensitive", U, D, Qd)
    memory = rng.standard_normal((N, T, D)).astype(np.float32)
    query = rng.standard_normal((N, Qd)).astype(np.float32)
    prev = rng.dirichlet(np.ones(T), N).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([9, 5, 1])[:, None]
    jkeys = JA.prepare_memory(p, jnp.asarray(memory))
    jmask = jnp.asarray(mask)
    tp = tree_t(p)
    tkeys = TA.prepare_memory(tp, t(memory))
    tmask = torch.from_numpy(mask)
    if window:
        jmask = JA.window_mask(jnp.asarray(prev), jmask, 1, 2)
        tmask = TA.window_mask(t(prev), tmask, 1, 2)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    jc, ja = JA.attention_step(p, "location_sensitive", jnp.asarray(query),
                               jnp.asarray(prev), jkeys, jnp.asarray(memory),
                               jmask)
    tc, ta = TA.attention_step(tp, "location_sensitive", t(query), t(prev),
                               tkeys, t(memory), tmask)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


# -- Tacotron-1's layers: highway, GRU, CBHG, the six attention types ---------

def test_highway_matches():
    rng = np.random.default_rng(4)
    p = JL.init_highway(jax.random.PRNGKey(4), 6)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    j = JL.highway(p, jnp.asarray(x))
    np.testing.assert_allclose(TL.highway(tree_t(p), t(x)).numpy(),
                               np.asarray(j), **TOL)


def gru_params(key, in_dim, units, rng):
    """A GRU with nonzero biases (init gives ones and zeros)."""
    p = JL.init_gru(key, in_dim, units)
    p["gate_bias"] = jnp.asarray(rng.standard_normal(2 * units).astype(np.float32))
    p["cand_bias"] = jnp.asarray(rng.standard_normal(units).astype(np.float32))
    return p


def test_gru_cell_matches():
    """The TF cell: candidate over [x, r*h] with one kernel."""
    rng = np.random.default_rng(5)
    p = gru_params(jax.random.PRNGKey(5), 6, 5, rng)
    x = rng.standard_normal((3, 6)).astype(np.float32)
    h = rng.standard_normal((3, 5)).astype(np.float32)
    j = JL.gru_cell(p, jnp.asarray(x), jnp.asarray(h))
    np.testing.assert_allclose(TL.gru_cell(tree_t(p), t(x), t(h)).numpy(),
                               np.asarray(j), **TOL)


@pytest.mark.parametrize("lengths", [None, [7, 3, 0, 5]])
@pytest.mark.parametrize("with_h0", [False, True])
def test_gru_rnns_with_lengths_match(lengths, with_h0):
    """gru_rnn and bigru_rnn on ragged rows: zero outputs past a row's
    length, the state held, the backward direction reversed over each
    row's own length, ``h0`` seeding both directions."""
    rng = np.random.default_rng(6)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(6), 3)
    pf, pb = gru_params(k1, 4, 6, rng), gru_params(k2, 4, 6, rng)
    pu = gru_params(k3, 4, 6, rng)
    x = rng.standard_normal((4, 7, 4)).astype(np.float32)
    h0 = rng.standard_normal((4, 6)).astype(np.float32) if with_h0 else None
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else t(h0)
    j = np.asarray(JL.bigru_rnn(pf, pb, jnp.asarray(x), jh0, jl, 6))
    out = TL.bigru_rnn(tree_t(pf), tree_t(pb), t(x), th0, tl, 6).numpy()
    assert out.shape == (4, 7, 12)
    np.testing.assert_allclose(out, j, **TOL)
    j = np.asarray(JL.gru_rnn(pu, jnp.asarray(x), jh0, jl, 6))
    uni = TL.gru_rnn(tree_t(pu), t(x), th0, tl, 6).numpy()
    np.testing.assert_allclose(uni, j, **TOL)
    if lengths is not None:
        assert not out[1, 3:].any() and not out[2].any() and not uni[1, 3:].any()


def bn_noise(tree, rng):
    """Non-trivial running statistics for every batch norm of a tree."""
    if isinstance(tree, dict):
        if set(tree) == {"mean", "var"}:
            n = tree["mean"].shape[0]
            return {"mean": jnp.asarray(rng.standard_normal(n).astype(np.float32)),
                    "var": jnp.asarray(rng.uniform(0.5, 2, n).astype(np.float32))}
        return {k: bn_noise(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [bn_noise(v, rng) for v in tree]
    return tree


@pytest.mark.parametrize("in_dim,K,proj,speaker", [
    (8, 4, [8], False),            # one projection, bottleneck to 128
    (128, 3, [16, 128], True),     # chained last projection, speaker highways
    (80, 2, [32, 80], False)])     # post-CBHG shape: bank widths 1-2
def test_cbhg_matches(in_dim, K, proj, speaker):
    """Even bank widths (2, 4) pad as XLA's SAME does; the max-pool is
    dropped; only the last projection chains; the residual joins before
    the bottleneck; with a speaker the highways double the width and the
    GRU starts from the speaker's state."""
    from nspeech_tpu.models import modules as JM
    from nspeech_tpu_torch.models import modules as TM

    rng = np.random.default_rng(7)
    spk_dim = 5 if speaker else None
    p, s, meta = JM.init_cbhg(jax.random.PRNGKey(7), in_dim, K, proj,
                              gru_units=12, num_highways=2, speaker_dim=spk_dim)
    s = bn_noise(s, rng)
    x = rng.standard_normal((3, 9, in_dim)).astype(np.float32)
    lengths = np.array([9, 4, 0], np.int32)
    spk = rng.standard_normal((3, 5)).astype(np.float32) if speaker else None
    j, _ = JM.cbhg(p, s, meta, jnp.asarray(x), jnp.asarray(lengths),
                   None if spk is None else jnp.asarray(spk), False)
    out = TM.cbhg(tree_t(p), tree_t(s), meta, t(x), torch.from_numpy(lengths),
                  None if spk is None else t(spk))
    assert out.shape == (3, 9, 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), **TOL)
    # the port's own init builds the same tree
    tp, ts, _ = TM.init_cbhg(np.random.default_rng(0), in_dim, K, proj,
                             gru_units=12, num_highways=2, speaker_dim=spk_dim)
    assert (jax.tree_util.tree_structure(tree_t(p))
            == jax.tree_util.tree_structure(tp))
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("att", JA.ATTENTION_TYPES)
@pytest.mark.parametrize("initial", [False, True])
def test_attention_step_matches(att, initial):
    """Every mechanism, masked rows included, from a random previous
    alignment or from the mechanism's initial one (bah_mon: position 0)."""
    rng = np.random.default_rng(8)
    N, T, U, D = 3, 9, 8, 10
    Qd = U                       # luong scores the query against the keys
    p = JA.init_attention(jax.random.PRNGKey(8), att, U, D, Qd)
    if att == "bah_mon":
        p["score_bias"] = jnp.asarray(np.float32(0.3))
    if att in ("bah_norm", "luong_scaled"):
        p["g"] = jnp.asarray(np.float32(0.7))
    memory = rng.standard_normal((N, T, D)).astype(np.float32)
    query = rng.standard_normal((N, Qd)).astype(np.float32)
    if initial:
        prev = np.asarray(JA.initial_alignments(att, N, T))
        tprev = TA.initial_alignments(att, N, T, "cpu")
        np.testing.assert_array_equal(tprev.numpy(), prev)
    else:
        prev = rng.dirichlet(np.ones(T), N).astype(np.float32)
        tprev = t(prev)
    mask = np.arange(T)[None, :] < np.array([9, 5, 1])[:, None]
    tp = tree_t(p)
    tinit = TA.init_attention(np.random.default_rng(0), att, U, D, Qd)
    assert sorted(tinit) == sorted(tp)
    jc, ja = JA.attention_step(p, att, jnp.asarray(query), jnp.asarray(prev),
                               JA.prepare_memory(p, jnp.asarray(memory)),
                               jnp.asarray(memory), jnp.asarray(mask))
    tc, ta = TA.attention_step(tp, att, t(query), tprev,
                               TA.prepare_memory(tp, t(memory)), t(memory),
                               torch.from_numpy(mask))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    assert not ta.numpy()[~mask].any()       # masked positions get 0
