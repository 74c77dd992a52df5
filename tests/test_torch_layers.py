"""The port's Tacotron-2 layers against the JAX package's: the LSTM cell,
the length-masked BiLSTM, conv + batch norm, and one location-sensitive
attention step. Tolerance 1e-5 (float32, sums in another order)."""

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
    tc, ta = TA.attention_step(tp, t(query), t(prev), tkeys, t(memory), tmask)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
