"""Speaker and gc ids outside their tables, at every entry point of the
port that takes them: ``Synthesizer.synthesize_batch``,
``WaveNetVocoder.vocode_batch``, ``StreamingTTS.stream_batch`` and the two
CLIs' ``--gc-id`` / ``--speaker``.

The port raises ``ClientError`` (the CLIs exit with its message) before
anything runs. This deviates from the JAX package on purpose: its
``jnp.take`` serves NaN rows for such ids, while on the card the port's
index would be a device-side assert that leaves the process's CUDA
context unusable. Here on the CPU the tests check that the error comes
before the acoustic model, the generator or the sampler is touched."""

import numpy as np
import pytest
import torch

from nspeech_tpu_torch.cli import generate_wavenet, synthesize
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.models import Tacotron2, WaveNet
from nspeech_tpu_torch.serving import (ClientError, StreamingTTS, Synthesizer,
                                       WaveNetVocoder)
from nspeech_tpu_torch.train import save_serving_checkpoint

torch.set_num_threads(1)

TACO = ("max_iters=4,encoder_conv_layers=1,postnet_conv_layers=1,"
        "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
        "postnet_conv_channels=16,expand_conv_channels=16,"
        "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
        "embedding_dim=16,griffin_lim_iters=2,num_speakers=3")
VOC = ("dilations_length=3,dilations_depth=1,residual_channels=8,"
       "dilation_channels=8,skip_channels=16,quantization_channels=64,"
       "lc_channels=80,gc_channels=4,gc_category_cardinality=3")


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    d = tmp_path_factory.mktemp("ids")
    cfg = load_config("taco2").parse(TACO)
    model = Tacotron2(cfg)
    params, bn = model.init(0)
    vcfg = load_config("wavenet").parse(VOC)
    net = WaveNet(vcfg)
    vparams = net.init(1)
    save_serving_checkpoint(str(d / "taco"), 1, "taco2", cfg, params, bn)
    save_serving_checkpoint(str(d / "voc"), 1, "wavenet", vcfg, vparams)
    return d, cfg, model, params, bn, vcfg, net, vparams


def untouched(*_a, **_k):
    raise AssertionError("ran before the ids were checked")


@pytest.mark.parametrize("entry,bad", [
    ("synthesize_batch", 3), ("vocode_batch", 3), ("vocode_batch", -2),
    ("stream_batch", 3), ("generate_cli", 3), ("synthesize_cli", 3)])
def test_out_of_range_ids_raise_client_error(serving, monkeypatch, entry, bad):
    d, cfg, model, params, bn, vcfg, net, vparams = serving
    syn = Synthesizer(cfg, text_bucket=16, device="cpu").set_variables(
        params, bn, model=model)
    voc = WaveNetVocoder(vcfg, device="cpu").set_variables(net, vparams)
    monkeypatch.setattr(model, "forward", untouched)
    monkeypatch.setattr(model, "attention_context", untouched)
    monkeypatch.setattr(net, "generate", untouched)
    message = rf"id {bad} out of range \[0, 3\)"
    if entry == "synthesize_batch":
        with pytest.raises(ClientError, match=message):
            syn.synthesize_batch(["one", "two"], [0, bad])
    elif entry == "vocode_batch":
        mels = np.zeros((2, 3, 80), np.float32)
        with pytest.raises(ClientError, match=message):
            voc.vocode_batch(mels, [1, bad])
        assert voc._gen is None               # nothing was packed
    elif entry == "stream_batch":
        tts = StreamingTTS(syn, voc, chunk_frames=4, text_bucket=16)
        with pytest.raises(ClientError, match=message):
            list(tts.stream_batch(["one", "two"], [bad, 1]))
    elif entry == "generate_cli":
        with pytest.raises(SystemExit, match=message):
            generate_wavenet.main([str(d / "voc"), "--gc-id", str(bad),
                                   "--device", "cpu"])
    else:
        with pytest.raises(SystemExit, match=message):
            synthesize.main(["--checkpoint", str(d / "taco"), "--text", "hi",
                             "--vocoder-checkpoint", str(d / "voc"),
                             "--speaker", str(bad), "--device", "cpu"])


def test_ids_inside_the_tables_still_serve(serving):
    """The last row of each table is served (the check is not off by one)."""
    d, cfg, model, params, bn, vcfg, net, vparams = serving
    syn = Synthesizer(cfg, text_bucket=16, device="cpu").set_variables(
        params, bn, model=model)
    wavs, mels, _ = syn.synthesize_batch(["one"], [2], want_features="mel")
    voc = WaveNetVocoder(vcfg, device="cpu").set_variables(net, vparams)
    out = voc.vocode_batch(mels[:, :2], [2], temperature=0.0)
    assert wavs[0].size > 0 and out.shape == (1, 500) and np.isfinite(out).all()
