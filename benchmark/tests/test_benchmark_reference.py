"""The plain references agree with the port at small sizes on the CPU
(the comparisons that decide ``correct`` hold them at full size on the
card)."""

import numpy as np
import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import dsp as rdsp
from benchmark.reference import taco1 as rtaco1
from benchmark.reference import taco2 as rtaco2
from benchmark.reference import wavenet as rwavenet
from benchmark.reference.text import to_ids
from conftest import small_config

TEXT = "Glue the sheet, to the dark blue background."


def _ids(n_pad=64):
    ids = to_ids(TEXT)
    x = torch.zeros(1, n_pad, dtype=torch.long)
    x[0, :len(ids)] = torch.tensor(ids)
    return x, torch.tensor([len(ids)])


def test_symbol_ids_equal_the_ports():
    from nspeech_tpu_torch.text import text_to_sequence
    assert to_ids(TEXT) == text_to_sequence(TEXT, ["english_cleaners"])


def test_taco2_mel_equals_the_ports():
    from nspeech_tpu_torch.config import Config
    from nspeech_tpu_torch.models import Tacotron2
    c = dict(small_config("tacotron2_wavenet")["taco2"], max_iters=7)
    params, bn = weights.make(list(rtaco2.param_shapes(c)), 5, 1, "cpu")
    x, n = _ids()
    port = Tacotron2(Config(c)).forward(params, bn, x, n)["mel_outputs"]
    ref = rtaco2.infer_mel(c, params, bn, x, n, 7)
    torch.testing.assert_close(port, ref, rtol=0, atol=1e-5)


def test_taco1_linear_equals_the_ports():
    from nspeech_tpu_torch.config import Config
    from nspeech_tpu_torch.models import Tacotron1
    c = dict(small_config("tacotron1_griffinlim")["taco1"], max_iters=7)
    params, bn = weights.make(list(rtaco1.param_shapes(c)), 6, 2, "cpu")
    x, n = _ids()
    out = Tacotron1(Config(c)).forward(params, bn, x, n)
    mel, lin = rtaco1.infer(c, params, bn, x, n, 7)
    torch.testing.assert_close(out["mel_outputs"], mel, rtol=0, atol=1e-5)
    torch.testing.assert_close(out["linear_outputs"], lin, rtol=0, atol=1e-5)


@pytest.mark.parametrize("row", [0, 3])
def test_wavenet_codes_are_the_argmax_of_logits_and_noise(row):
    from nspeech_tpu_torch.config import Config
    from nspeech_tpu_torch.models import WaveNet
    c = small_config("tacotron2_wavenet")["wavenet"]
    (params,) = weights.make([rwavenet.param_shapes(c)], 7, 1, "cpu")
    net = WaveNet(Config(c))
    n = 200
    lc = torch.randn(row + 1, n, c["lc_channels"])
    codes = net.generate(params, n, seed=11, batch=row + 1, lc=lc, temperature=1.0)[row]
    inputs = torch.cat([torch.tensor([c["quantization_channels"] // 2]), codes[:-1].long()])
    z = rwavenet.logits(c, params, inputs, lc[row]) + rwavenet.gumbel(
        11, torch.arange(n), row, c["quantization_channels"])
    gap = z.max(dim=1).values - z.gather(1, codes.long()[:, None])[:, 0]
    assert float(gap.max()) < 1e-4


def test_features_equal_the_ports():
    from nspeech_tpu_torch.config import Config
    from nspeech_tpu_torch.dsp.audio import spectrograms
    c = small_config("tacotron2_wavenet")["taco2"]
    wav = np.sin(np.arange(3000) * 0.3).astype(np.float32) * 0.5
    lin, mel = spectrograms(wav, Config(c))
    rlin, rmel = rdsp.featurize(wav, c)
    np.testing.assert_allclose(lin, rlin, atol=1e-5)
    np.testing.assert_allclose(mel, rmel, atol=1e-5)


def test_griffin_lim_phase_and_waveform_equal_the_ports():
    from nspeech_tpu_torch import dsp
    from nspeech_tpu_torch.config import Config
    from nspeech_tpu_torch.serving.synthesizer import Synthesizer
    c = small_config("tacotron1_griffinlim")["taco1"]
    synth = Synthesizer(Config(c), device="cpu")
    phase = synth.initial_phase((4, 20, c["num_freq"]), slice(2, 3))[0]
    np.testing.assert_array_equal(phase.numpy(), rdsp.initial_phase(4, 2, (20, c["num_freq"])))
    lin = torch.rand(20, c["num_freq"])
    port = dsp.inv_preemphasis(dsp.inv_spectrogram(lin, Config(c), phase=phase),
                               c["preemphasis"]).numpy()
    ref = rdsp.inv_preemphasis(rdsp.griffin_lim(lin, phase, c).numpy(), c["preemphasis"])
    np.testing.assert_allclose(port, ref, atol=1e-4 * np.abs(ref).max())
    assert dsp.find_endpoint(port, Config(c)) == rdsp.find_endpoint(ref, c)


def test_mu_law_and_upsampling_equal_the_ports():
    from nspeech_tpu_torch.dsp.mulaw import mu_law_decode
    from nspeech_tpu_torch.ops.upsample import upsample_on_device
    np.testing.assert_allclose(mu_law_decode(torch.arange(256), 256).numpy(),
                               rdsp.mu_law_table(256), atol=2e-7)
    mel = torch.randn(12, 8)
    torch.testing.assert_close(upsample_on_device(mel[None], 25, 300)[0],
                               rdsp.upsample(mel, 25, 300), rtol=0, atol=1e-5)


def test_control_rounds_products_to_tf32():
    from benchmark.reference import mm, precision
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    exact = mm(a, b)
    with precision(True):
        low = mm(a, b)
    assert 1e-4 < float((low - exact).abs().max()) < 0.1
    assert torch.equal(mm(a, b), exact)
