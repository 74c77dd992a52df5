"""How closely the port's training path follows the JAX package's, on the
CPU: the numbers behind the tolerances of ``tests/test_torch_train_*.py``.

    python scripts/torch_train_parity_report.py

Needs both packages (JAX on the CPU). On the synthetic corpus of
``tests/make_synth_corpus.py`` (6 utterances) it prints:

1. The featurizer: the largest gap between the port's and the JAX
   package's linear and mel spectrograms, and each one's gap to a float64
   FFT of the same frames.
2. The gradients of one training step at tiny widths (the tests' configs)
   against those of JAX's default train step (deferred weight gradients
   on), per Tacotron: the worst leaf's largest error over its largest
   entry, and, for the conv biases whose gradient cancels to near 0
   (batch norm follows them), the largest absolute error.
"""

from __future__ import annotations

import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

sys.path.insert(0, os.getcwd())
jax.config.update("jax_platforms", "cpu")

from nspeech_tpu import dsp as jdsp  # noqa: E402
from nspeech_tpu.config import load_config as j_load  # noqa: E402
from nspeech_tpu.data.feeder import DataFeeder as JFeeder  # noqa: E402
from nspeech_tpu.models.tacotron import Tacotron1 as JTaco1  # noqa: E402
from nspeech_tpu.models.tacotron2 import Tacotron2 as JTaco2  # noqa: E402
from nspeech_tpu.train import loop as jloop  # noqa: E402
from nspeech_tpu.train.optim import make_optimizer  # noqa: E402
from nspeech_tpu_torch import convert  # noqa: E402
from nspeech_tpu_torch.config import load_config as t_load, stft_params  # noqa: E402
from nspeech_tpu_torch.data.corpus import load_items  # noqa: E402
from nspeech_tpu_torch.dsp import audio as taudio  # noqa: E402
from nspeech_tpu_torch.dsp.mel import mel_filterbank  # noqa: E402
from nspeech_tpu_torch.dsp.trim import trim_wav  # noqa: E402
from nspeech_tpu_torch.dsp.wavio import load_wav  # noqa: E402
from nspeech_tpu_torch.models import Tacotron1 as TTaco1  # noqa: E402
from nspeech_tpu_torch.models import Tacotron2 as TTaco2  # noqa: E402
from nspeech_tpu_torch.train import loop as tloop  # noqa: E402
from nspeech_tpu_torch.utils.tree import named_leaves  # noqa: E402
from tests.make_synth_corpus import make_corpus  # noqa: E402

TINY = {
    "taco2": ("encoder_conv_layers=2,postnet_conv_layers=2,expand_conv_layers=2,"
              "encoder_conv_channels=32,attention_dim=32,postnet_conv_channels=32,"
              "expand_conv_channels=32,decoder_lstm_units=32,"
              "encoder_lstm_units=16,expand_lstm_units=16,embedding_dim=32"),
    "taco1": ("encoder_cbhg_banks=2,post_cbhg_banks=2,attention_dim=32,"
              "decoder_dim=32,embedding_dim=32"),
}


def float64_features(wav, cfg):
    n_fft, hop, win = stft_params(cfg)
    emph = taudio.preemphasis(wav, cfg.preemphasis).astype(np.float64)
    mode = "reflect" if len(emph) > n_fft // 2 else "constant"
    padded = np.pad(emph, (n_fft // 2, n_fft // 2), mode=mode)
    frames = np.lib.stride_tricks.sliding_window_view(padded, n_fft)[::hop]
    window = taudio._padded_window(n_fft, win, "cpu").numpy().astype(np.float64)
    mag = np.abs(np.fft.rfft(frames * window, axis=-1))
    floor = -abs(cfg.min_level_db)
    lin = np.clip((20 * np.log10(np.maximum(1e-5, mag)) - cfg.ref_level_db - floor)
                  / -floor, 0, 1)
    mel_basis = mel_filterbank(cfg.sample_rate, n_fft, cfg.num_mels).astype(np.float64)
    mel = np.clip((20 * np.log10(np.maximum(1e-5, mag @ mel_basis.T)) - floor)
                  / -floor, 0, 1)
    return lin, mel


def featurizer_report(corpus) -> None:
    jc, tc = j_load("taco2"), t_load("taco2")
    gaps = np.zeros(5)
    for wav_path, *_ in load_items({"ljspeech": corpus}):
        wav = trim_wav(load_wav(wav_path, tc.sample_rate))
        t_lin, t_mel = taudio.spectrograms(wav, tc)
        j_lin, j_mel = (np.asarray(x) for x in jdsp.spectrograms(wav, jc))
        f_lin, f_mel = float64_features(wav, tc)
        gaps = np.maximum(gaps, [np.abs(t_lin - j_lin).max(), np.abs(t_mel - j_mel).max(),
                                 np.abs(j_lin - f_lin).max(), np.abs(t_lin - f_lin).max(),
                                 np.abs(j_mel - f_mel).max()])
    print("featurizer, port vs JAX: linear %.2e, mel %.2e; against a float64 "
          "FFT: JAX linear %.2e, port linear %.2e, JAX mel %.2e" % tuple(gaps))


def capture(tx):
    def init(params):
        return ({"g": jax.tree_util.tree_map(jnp.zeros_like, params)},
                tx.init(params))

    def update(g, state, params=None):
        u, s = tx.update(g, state[1], params)
        return u, ({"g": g}, s)

    return optax.GradientTransformation(init, update)


def gradient_report(corpus, name) -> None:
    ov = TINY[name] + ",batch_size=2,batch_group_size=2,drop_rate=0.0"
    jc, tc = j_load(name).parse(ov), t_load(name).parse(ov)
    jm, tm = (JTaco2(jc), TTaco2(tc)) if name == "taco2" else (JTaco1(jc), TTaco1(tc))
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = convert.tacotron_variables(tm, jax.tree_util.tree_map(np.asarray, jp),
                                        jax.tree_util.tree_map(np.asarray, js))
    batch = next(JFeeder({"ljspeech": corpus}, jc, seed=0).epoch_batches(0))
    tx, sched = make_optimizer(jc, name)
    step = jloop.build_tacotron_train_step(jm, capture(tx), schedule=sched)
    state = jloop.TrainState(jnp.zeros((), jnp.int32), jp, js, capture(tx).init(jp))
    state, _ = step(state, batch, jax.random.PRNGKey(1))
    j_grads = jax.tree_util.tree_leaves(state.opt_state[0]["g"])
    t_grads = named_leaves(tloop.tacotron_grads(
        tm, tloop.TrainState(0, tp, ts, None), tloop.batch_to_device(batch, "cpu"),
        None)[0])
    worst = (0.0, "")
    worst_cancelled = (0.0, "")
    for j, (path, t) in zip(j_grads, t_grads):
        j = np.asarray(j)
        err, largest = float(np.abs(t.numpy() - j).max()), float(np.abs(j).max())
        if path.endswith("/conv/bias") and largest < 1e-3:
            worst_cancelled = max(worst_cancelled, (err, path))
        else:
            worst = max(worst, (err / max(largest, 1e-30), path))
    print("%s gradients, port vs JAX's default step: worst leaf %.2e of its "
          "largest entry (%s); conv biases whose gradient cancels (largest "
          "entry below 1e-3): worst %.2e absolute (%s)"
          % (name, worst[0], worst[1], worst_cancelled[0], worst_cancelled[1]))


def main() -> int:
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = make_corpus(os.path.join(tmp, "corpus"), n=6)
        featurizer_report(corpus)
        for name in ("taco2", "taco1"):
            gradient_report(corpus, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
