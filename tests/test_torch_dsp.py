"""The port's DSP (mu-law, upsampling, STFT/ISTFT, Griffin-Lim, inverse
pre-emphasis, endpointing) against the JAX package's, on the CPU.

Tolerances: float32 FFTs and sums taken in another order differ in the
last bits, so spectral paths compare within 1e-4 of the signal scale;
upsampling and mu-law coding are compared bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nspeech_tpu import dsp as jdsp
from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.config import stft_params
from nspeech_tpu.dsp import audio as jaudio
from nspeech_tpu.ops.upsample import upsample_on_device as j_upsample
from nspeech_tpu_torch import dsp as tdsp
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.ops.upsample import upsample_on_device as t_upsample

torch.set_num_threads(1)


def _mu_law_edges(q):
    """Every decision edge of the Q-level encoder (the input where the
    code steps from c - 1 to c), rounded to float32, with its neighbours
    one ulp below and above."""
    mu = q - 1.0
    signal = (np.arange(1, q) - 0.5) * 2.0 / mu - 1.0
    edge = (np.sign(signal) * np.expm1(np.abs(signal) * np.log1p(mu)) / mu
            ).astype(np.float32)
    return np.concatenate([np.nextafter(edge, np.float32(-2)), edge,
                           np.nextafter(edge, np.float32(2))])


def test_mu_law_matches():
    """The encoder reproduces XLA's CPU arithmetic (its own log1p and
    FMAs): no code differs over 2,000,000 seeded inputs and every decision
    edge at +-1 ulp."""
    rng = np.random.default_rng(0)
    for q in (64, 256):
        audio = np.concatenate([rng.uniform(-1, 1, 2_000_000),
                                rng.uniform(-1.2, 1.2, 4000), [0.0, 1.0, -1.0],
                                _mu_law_edges(q)]).astype(np.float32)
        j = np.asarray(jdsp.mu_law_encode(jnp.asarray(audio), q))
        t = tdsp.mu_law_encode(torch.from_numpy(audio), q).numpy()
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, j)
        codes = np.arange(q, dtype=np.int32)
        jd = np.asarray(jdsp.mu_law_decode(jnp.asarray(codes), q))
        td = tdsp.mu_law_decode(torch.from_numpy(codes), q).numpy()
        np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("hop,length", [(250, 250 * 7), (250, 1234), (5, 37)])
def test_upsample_bit_exact(hop, length):
    rng = np.random.default_rng(1)
    mels = rng.random((2, 8, 80)).astype(np.float32)
    j = np.asarray(j_upsample(jnp.asarray(mels), hop, length))
    t = t_upsample(torch.from_numpy(mels), hop, length).numpy()
    np.testing.assert_array_equal(t, j)


def test_stft_istft_match():
    cfg = j_load("taco2")
    n_fft, hop, win = stft_params(cfg)
    rng = np.random.default_rng(2)
    y = rng.standard_normal(6000).astype(np.float32) * 0.3
    js = np.array(jaudio.stft(jnp.asarray(y), n_fft, hop, win))
    ts = tdsp.stft(torch.from_numpy(y), n_fft, hop, win).numpy()
    np.testing.assert_allclose(ts, js, atol=1e-3 * np.abs(js).max())
    ji = np.asarray(jaudio.istft(jnp.asarray(js), n_fft, hop, win))
    ti = tdsp.istft(torch.from_numpy(js), n_fft, hop, win).numpy()
    np.testing.assert_allclose(ti, ji, atol=1e-5)


def test_inv_spectrogram_same_phase():
    """Griffin-Lim from the same initial phase on both sides (the JAX CPU
    path draws ``uniform(key, S.shape)``; that array is handed to the
    port)."""
    jcfg = j_load("taco2").parse("griffin_lim_iters=4")
    tcfg = t_load("taco2").parse("griffin_lim_iters=4")
    rng = np.random.default_rng(3)
    lin = rng.random((24, jcfg.num_freq)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    phase = np.asarray(jax.random.uniform(key, lin.shape))
    j = np.asarray(jdsp.inv_spectrogram(jnp.asarray(lin), jcfg, key=key))
    t = tdsp.inv_spectrogram(torch.from_numpy(lin), tcfg,
                             phase=torch.from_numpy(phase)).numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=1e-4 * np.abs(j).max())
    # batched rows are independent inversions
    tb = tdsp.inv_spectrogram(torch.from_numpy(np.stack([lin, lin[::-1]])),
                              tcfg, phase=torch.from_numpy(
                                  np.stack([phase, phase]))).numpy()
    np.testing.assert_allclose(tb[0], t, atol=1e-6 * np.abs(t).max())


def test_griffin_lim_momentum_matches():
    jcfg = j_load("taco2").parse("griffin_lim_iters=3,griffin_lim_momentum=0.9")
    tcfg = t_load("taco2").parse("griffin_lim_iters=3,griffin_lim_momentum=0.9")
    lin = np.random.default_rng(4).random((16, jcfg.num_freq)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    phase = np.asarray(jax.random.uniform(key, lin.shape))
    j = np.asarray(jdsp.inv_spectrogram(jnp.asarray(lin), jcfg, key=key))
    t = tdsp.inv_spectrogram(torch.from_numpy(lin), tcfg,
                             phase=torch.from_numpy(phase)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4 * np.abs(j).max())


@pytest.mark.parametrize("n", [1, 255, 256, 257, 70001])
def test_inv_preemphasis_matches_scan(n):
    x = np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)
    j = np.asarray(jdsp.inv_preemphasis(jnp.asarray(x), 0.97))
    t = tdsp.inv_preemphasis(torch.from_numpy(x), 0.97).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    # and it inverts pre-emphasis
    emph = np.concatenate([t[:1], t[1:] - 0.97 * t[:-1]])
    np.testing.assert_allclose(emph, x, atol=1e-4)


def test_find_endpoint_matches():
    cfg_j, cfg_t = j_load("taco2"), t_load("taco2")
    rng = np.random.default_rng(6)
    wav = np.concatenate([rng.uniform(-0.5, 0.5, 30000),
                          np.zeros(40000), rng.uniform(-0.5, 0.5, 100)])
    assert tdsp.find_endpoint(wav, cfg_t) == jdsp.find_endpoint(wav, cfg_j)
    assert tdsp.find_endpoint(wav, cfg_t) < len(wav)
    loud = rng.uniform(-0.5, 0.5, 50000)
    assert tdsp.find_endpoint(loud, cfg_t) == jdsp.find_endpoint(loud, cfg_j) == len(loud)
