"""The port's serving path end to end against the JAX package's: text ->
Tacotron-2 -> Griffin-Lim endpoint -> mel-conditioned WaveNet -> waveform,
at tiny widths on the CPU (the port's sampler wrapper runs its plain
version there).

Both sides get the same weights (bridged) and draw the same Griffin-Lim
initial phase: the port's synthesizer draws JAX's per-row
``uniform(split(PRNGKey(0), n)[i])`` itself (``ops/threefry.py``).
Tolerances: mel within 1e-4; at temperature 0 the
codes must be identical, so the vocoded waveforms agree to float32
rounding of the mu-law decode (1e-6)."""

import jax
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models import create_model
from nspeech_tpu.serving import Synthesizer as JSynth
from nspeech_tpu.serving import TextToSpeech as JTTS
from nspeech_tpu.serving import WaveNetVocoder as JVoc
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models import Tacotron2, WaveNet
from nspeech_tpu_torch.serving import ClientError
from nspeech_tpu_torch.serving import Synthesizer as TSynth
from nspeech_tpu_torch.serving import TextToSpeech as TTTS
from nspeech_tpu_torch.serving import WaveNetVocoder as TVoc

torch.set_num_threads(1)

TACO = ("max_iters=4,encoder_conv_layers=1,postnet_conv_layers=1,"
        "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
        "postnet_conv_channels=16,expand_conv_channels=16,"
        "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
        "embedding_dim=16,griffin_lim_iters=2")
VOC = ("dilations_length=3,dilations_depth=1,residual_channels=8,"
       "dilation_channels=8,skip_channels=16,quantization_channels=64,"
       "lc_channels=80,gc_channels=4,gc_category_cardinality=3")


@pytest.fixture(scope="module")
def pipelines():
    jcfg, tcfg = j_load("taco2").parse(TACO), t_load("taco2").parse(TACO)
    jmodel = create_model("taco2", jcfg)
    jp, js = jmodel.init(jax.random.PRNGKey(0))
    jsyn = JSynth(jcfg, text_bucket=16).set_variables(jp, js, model=jmodel)
    tmodel = Tacotron2(tcfg)
    tp, ts = convert.tacotron2_variables(
        tmodel, jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js))
    tsyn = TSynth(tcfg, text_bucket=16, device="cpu").set_variables(
        tp, ts, model=tmodel)

    jvcfg, tvcfg = j_load("wavenet").parse(VOC), t_load("wavenet").parse(VOC)
    jnet = create_model("wavenet", jvcfg)
    jvp = jnet.init(jax.random.PRNGKey(1))
    jvoc = JVoc(jvcfg, use_pallas=False).set_variables(jnet, jvp)
    tnet = WaveNet(tvcfg)
    tvoc = TVoc(tvcfg, device="cpu").set_variables(
        tnet, convert.wavenet_params(tnet, jax.tree_util.tree_map(np.asarray, jvp)))
    return JTTS(jsyn, jvoc), TTTS(tsyn, tvoc)


@pytest.mark.parametrize("text,speaker", [("hi there", -1), ("Testing, one two.", 2)])
def test_text_to_speech_matches(pipelines, text, speaker):
    jtts, ttts = pipelines
    jw, jm, jl, jgl = jtts.synthesize(text, speaker, temperature=0.0, return_gl=True)
    tw, tm, tl, tgl = ttts.synthesize(text, speaker, temperature=0.0, return_gl=True)
    np.testing.assert_allclose(tm, jm, atol=1e-4)
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert tgl.shape == jgl.shape
    np.testing.assert_allclose(tgl, jgl, atol=1e-4 * max(np.abs(jgl).max(), 1e-3))
    assert tw.shape == jw.shape and tw.size > 0
    np.testing.assert_allclose(tw, jw, atol=1e-6)


def test_text_to_speech_batch_matches(pipelines):
    jtts, ttts = pipelines
    texts = ["a short one", "and a somewhat longer sentence", "third"]
    jws, jms, _ = jtts.synthesize_batch(texts, [0, 1, 2], temperature=0.0)
    tws, tms, _ = ttts.synthesize_batch(texts, [0, 1, 2], temperature=0.0)
    np.testing.assert_allclose(tms, jms, atol=1e-4)
    assert len(tws) == len(jws) == 3
    for tw, jw in zip(tws, jws):
        assert tw.shape == jw.shape
        np.testing.assert_allclose(tw, jw, atol=1e-6)


def test_batch_rejects_mixed_speakers(pipelines):
    _, ttts = pipelines
    with pytest.raises(ClientError):
        ttts.synthesize_batch(["a", "b"], [0, -1])


def test_griffin_lim_route_without_vocoder(pipelines):
    jtts, ttts = pipelines
    jw, _, _ = JTTS(jtts.synthesizer).synthesize("no vocoder here")
    tw, _, _ = TTTS(ttts.synthesizer).synthesize("no vocoder here")
    assert tw.shape == jw.shape
    np.testing.assert_allclose(tw, jw, atol=1e-4 * max(np.abs(jw).max(), 1e-3))
