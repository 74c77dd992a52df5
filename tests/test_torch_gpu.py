"""Card-only tests of the port (marker ``gpu``): the CUDA sampler against
its plain PyTorch version, the wrapper's checks, and the serving path on
the card. They skip without a CUDA device.

Unlike the other ``test_torch_*`` files this one imports no JAX, so that it
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

(``--noconftest``: the suite's conftest pins JAX to the CPU and needs JAX.)
Tolerance: the kernel's code must score within 1e-4 of the plain
version's best score at every step (same inputs, same Philox noise;
float32 sums in another order)."""

import numpy as np
import pytest
import torch

from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.models import Tacotron2, WaveNet
from nspeech_tpu_torch.ops.cuda import wavenet_gen
from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
from nspeech_tpu_torch.ops.layers import tree_to
from nspeech_tpu_torch.ops.philox import gumbel_noise

torch.set_num_threads(1)

TINY_WN = ("dilations_length=3,dilations_depth=2,residual_channels=8,"
           "dilation_channels=8,skip_channels=16,quantization_channels=64,"
           "lc_channels=5,gc_channels=4,gc_category_cardinality=3")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the sampler kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tiny_vocoder(device, extra=""):
    net = WaveNet(load_config("wavenet").parse(TINY_WN + extra))
    return net, tree_to(net.init(0), device)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,temperature,extra", [
    (1, 0.0, ""), (1, 1.0, ""), (3, 1.0, ""), (3, 0.7, ",use_biases=True")])
def test_kernel_matches_plain_teacher_forced(cuda, batch, temperature, extra):
    net, params = tiny_vocoder(cuda, extra)
    n = 300
    lc = torch.rand(batch, n, 5, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    gc = [2, 0, 1][:batch]
    before = wavenet_gen.SAMPLER.launches
    codes = CudaWaveNetGenerator(net, params, gc_ids=gc)(
        n, seed=9, batch=batch, lc=lc, temperature=temperature)
    assert wavenet_gen.SAMPLER.launches == before + 1
    assert codes.shape == (batch, n) and codes.dtype == torch.int32
    inputs = torch.cat([torch.full((batch, 1), 32, device=cuda,
                                   dtype=torch.int32), codes[:, :-1]], 1)
    _, logits = net.generate(params, 0, seed=9, batch=batch, gc_ids=gc, lc=lc,
                             seed_codes=inputs, temperature=temperature,
                             return_logits=True, include_prime=True)
    scores = logits
    if temperature > 0:
        g = gumbel_noise(9, torch.arange(n, device=cuda), batch, 64)
        scores = logits * (1.0 / temperature) + g.permute(1, 0, 2)
    best = scores.max(-1).values
    chosen = scores.gather(-1, codes.long()[..., None])[..., 0]
    assert (best - chosen).max().item() <= 1e-4


@pytest.mark.gpu
def test_wrapper_checks_inputs(cuda):
    net, params = tiny_vocoder(cuda)
    gen = CudaWaveNetGenerator(net, params, gc_ids=[0, 1])
    lc_cpu = torch.rand(2, 10, 5)
    with pytest.raises(ValueError):
        gen(10, batch=2, lc=lc_cpu)                       # lc off the card
    with pytest.raises(ValueError):
        gen(10, batch=3, lc=torch.rand(3, 10, 5, device=cuda))  # 2 speakers, 3 streams
    with pytest.raises(ValueError):
        gen(10, batch=2, lc=torch.rand(2, 10, 5, device=cuda, dtype=torch.float64))


@pytest.mark.gpu
def test_text_to_speech_on_card_launches_the_kernel(cuda):
    from nspeech_tpu_torch.serving import Synthesizer, TextToSpeech, WaveNetVocoder

    cfg = load_config("taco2").parse(
        "max_iters=6,encoder_conv_layers=1,postnet_conv_layers=1,"
        "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
        "postnet_conv_channels=16,expand_conv_channels=16,"
        "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
        "embedding_dim=16,griffin_lim_iters=2")
    model = Tacotron2(cfg)
    params, bn = model.init(0)
    syn = Synthesizer(cfg, text_bucket=16).set_variables(params, bn, model=model)
    vcfg = load_config("wavenet").parse(TINY_WN.replace("lc_channels=5", "lc_channels=80"))
    net = WaveNet(vcfg)
    tts = TextToSpeech(syn, WaveNetVocoder(vcfg).set_variables(net, net.init(1)))
    before = wavenet_gen.SAMPLER.launches
    wav, mel, _ = tts.synthesize("hello on the card", temperature=1.0)
    wavs, _, _ = tts.synthesize_batch(["one", "two streams"], [0, 2])
    assert wavenet_gen.SAMPLER.launches == before + 2
    assert mel.shape == (30, 80)
    for w in [wav, *wavs]:
        assert w.size > 0 and np.isfinite(w).all()
