"""Card-only tests of the port (marker ``gpu``): the CUDA sampler (one-shot,
primed and carried-state launches) against its plain PyTorch version, the
wrapper's checks, the one-shot and streaming serving paths on the card,
Tacotron-1 on the card against its CPU forward (within 1e-3, TF32 off),
and concurrent callers sharing launches through the ``DynamicBatcher``.
They skip without a CUDA device.

Unlike the other ``test_torch_*`` files this one imports no JAX, so that it
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

(``--noconftest``: the suite's conftest pins JAX to the CPU and needs JAX.)
Tolerance: the kernel's code must score within 1e-4 of the plain
version's best score at every step (same inputs, same Philox noise;
float32 sums in another order); resumed rings within 1e-4 relative.
Carried launches against one launch: identical (same kernel, same
arithmetic, same noise). The kernel runs one 8-CTA cluster per stream:
a batch with more streams than clusters fit on the card runs in waves
and must give what the plain version gives; a model without local
conditioning (M = 0, the ``simple_wavenet`` preset) runs without the
cluster's lc projection."""

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


def score_gap(net, params, carry, codes, lc, gc, seed, temperature):
    """Largest gap between the plain version's best score and the score of
    the kernel's code, the plain version fed the kernel's codes as its
    inputs from ``carry``; returns (gap, the plain version's new carry)."""
    batch, n = codes.shape
    inputs = torch.cat([carry[1][:, None].long(), codes[:, :-1].long()], 1)
    logits = []
    _, plain_carry = net.sample(params, carry, n, seed, net._embed_gc(params, gc),
                                lc, temperature, forced=inputs, logits_all=logits)
    scores = torch.stack(logits, 1)
    if temperature > 0:
        t = torch.arange(carry[0], carry[0] + n, device=codes.device)
        g = gumbel_noise(seed, t, batch, net.quantization_channels)
        scores = scores * (1.0 / temperature) + g.permute(1, 0, 2)
    chosen = scores.gather(-1, codes.long()[..., None])[..., 0]
    return (scores.max(-1).values - chosen).max().item(), plain_carry


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
@pytest.mark.parametrize("batch,temperature", [(1, 0.0), (1, 1.0), (3, 0.0),
                                               (3, 1.0)])
def test_primed_kernel_matches_plain_teacher_forced(cuda, batch, temperature):
    """K3: 40 forced codes then 120 free samples. The kept codes are held
    against the plain version fed the seed and then the kernel's own codes
    (steps P - 1 onwards of its ``include_prime`` logits)."""
    net, params = tiny_vocoder(cuda)
    P, n = 40, 120
    gen_ = torch.Generator(cuda).manual_seed(3)
    seeds = torch.randint(0, 64, (batch, P), device=cuda, generator=gen_,
                          dtype=torch.int32)
    lc = torch.rand(batch, P + n, 5, device=cuda, generator=gen_)
    gc = [2, 0, 1][:batch]
    before = wavenet_gen.PRIMED_SAMPLER.launches
    one_shot = wavenet_gen.SAMPLER.launches
    codes = CudaWaveNetGenerator(net, params, gc_ids=gc)(
        n, seed=6, batch=batch, seed_codes=seeds, lc=lc, temperature=temperature)
    assert wavenet_gen.PRIMED_SAMPLER.launches == before + 1
    assert wavenet_gen.SAMPLER.launches == one_shot
    assert codes.shape == (batch, n)
    inputs = torch.cat([seeds, codes[:, :-1]], 1)
    _, logits = net.generate(params, 0, seed=6, batch=batch, gc_ids=gc, lc=lc,
                             seed_codes=inputs, temperature=temperature,
                             return_logits=True, include_prime=True)
    scores = logits[:, P - 1:]
    if temperature > 0:
        g = gumbel_noise(6, torch.arange(P - 1, P - 1 + n, device=cuda), batch, 64)
        scores = scores * (1.0 / temperature) + g.permute(1, 0, 2)
    chosen = scores.gather(-1, codes.long()[..., None])[..., 0]
    assert (scores.max(-1).values - chosen).max().item() <= 1e-4


@pytest.mark.gpu
def test_primed_wrapper_checks_seed_codes(cuda):
    net, params = tiny_vocoder(cuda)
    gen = CudaWaveNetGenerator(net, params, gc_ids=[0, 1])
    lc = torch.rand(2, 30, 5, device=cuda)
    seeds = torch.zeros(2, 10, dtype=torch.int32, device=cuda)
    before = wavenet_gen.PRIMED_SAMPLER.launches
    with pytest.raises(ValueError):
        gen(20, batch=2, lc=lc, seed_codes=seeds + 64)            # code >= Q
    with pytest.raises(ValueError):
        gen(20, batch=2, lc=lc, seed_codes=seeds - 1)             # code < 0
    with pytest.raises(ValueError):
        gen(20, batch=2, lc=lc, seed_codes=seeds[:1])             # batch
    with pytest.raises(ValueError):
        gen(20, batch=2, lc=lc, seed_codes=seeds.cpu())           # off the card
    with pytest.raises(ValueError):
        gen(20, batch=2, lc=lc, seed_codes=seeds.long())          # not int32
    assert wavenet_gen.PRIMED_SAMPLER.launches == before
    # an empty seed primes nothing: a one-shot launch
    one_shot = wavenet_gen.SAMPLER.launches
    gen(20, batch=2, lc=lc, seed_codes=seeds[:, :0])
    assert wavenet_gen.SAMPLER.launches == one_shot + 1


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


@pytest.mark.gpu
@pytest.mark.parametrize("batch,temperature", [(1, 0.0), (3, 1.0)])
def test_carried_launches_equal_one_launch(cuda, batch, temperature):
    net, params = tiny_vocoder(cuda)
    n = 300
    lc = torch.rand(batch, n, 5, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    gen = CudaWaveNetGenerator(net, params, gc_ids=[2, 0, 1][:batch])
    one = gen(n, seed=4, batch=batch, lc=lc, temperature=temperature)
    before = wavenet_gen.CARRIED_SAMPLER.launches
    carry, parts, s = gen.chunk_carry0(batch), [], 0
    for size in (100, 1, 199):
        codes, carry = gen.generate_chunk(carry, size, seed=4,
                                          lc=lc[:, s:s + size],
                                          temperature=temperature)
        parts.append(codes)
        s += size
    assert wavenet_gen.CARRIED_SAMPLER.launches == before + 3
    assert torch.equal(torch.cat(parts, 1), one)
    assert carry[0] == n and torch.equal(carry[1], one[:, -1])
    assert torch.equal(carry[2], one[:, -2])


@pytest.mark.gpu
def test_kernel_resumes_a_carry_like_plain(cuda):
    """A carry the kernel made, far into a stream (t0 = 30000 + 77), is
    resumed by the kernel and by the plain version: teacher-forced scores
    agree and so do the carries they leave. The input carry is left as
    it was."""
    net, params = tiny_vocoder(cuda)
    gen = CudaWaveNetGenerator(net, params, gc_ids=[1, 2])
    lc = torch.rand(2, 30077 + 200, 5, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    _, carry = gen.generate_chunk(gen.chunk_carry0(2), 30077, seed=8,
                                  lc=lc[:, :30077], temperature=1.0)
    saved = [carry[0]] + [v.clone() for v in carry[1:]]
    codes, k_carry = gen.generate_chunk(carry, 200, seed=8, lc=lc[:, 30077:],
                                        temperature=1.0)
    assert carry[0] == saved[0]
    assert all(torch.equal(v, w) for v, w in zip(carry[1:], saved[1:]))
    gap, p_carry = score_gap(net, params, carry, codes, lc[:, 30077:], [1, 2],
                             8, 1.0)
    assert gap <= 1e-4
    assert k_carry[0] == p_carry[0] == 30277
    assert torch.equal(k_carry[1], p_carry[1])
    assert torch.equal(k_carry[2], p_carry[2])
    scale = p_carry[3].abs().max()
    assert (k_carry[3] - p_carry[3]).abs().max() <= 1e-4 * scale


@pytest.mark.gpu
def test_streaming_on_card_launches_the_carried_kernel(cuda):
    from nspeech_tpu_torch.serving import StreamingTTS, Synthesizer, WaveNetVocoder

    cfg = load_config("taco2").parse(
        "max_iters=6,outputs_per_step=2,encoder_conv_layers=1,"
        "postnet_conv_layers=2,postnet_conv_width=3,expand_conv_layers=1,"
        "encoder_conv_channels=16,attention_dim=16,postnet_conv_channels=16,"
        "expand_conv_channels=16,decoder_lstm_units=16,encoder_lstm_units=8,"
        "expand_lstm_units=8,embedding_dim=16,num_speakers=3")
    model = Tacotron2(cfg)
    params, bn = model.init(0)
    syn = Synthesizer(cfg, text_bucket=16).set_variables(params, bn, model=model)
    vcfg = load_config("wavenet").parse(TINY_WN.replace("lc_channels=5", "lc_channels=80"))
    net = WaveNet(vcfg)
    voc = WaveNetVocoder(vcfg).set_variables(net, net.init(1))
    tts = StreamingTTS(syn, voc, chunk_frames=4, temperature=1.0, text_bucket=16)
    before = wavenet_gen.CARRIED_SAMPLER.launches
    wavs = tts.synthesize_batch(["hello on the card", "two"], [0, 2])
    assert wavenet_gen.CARRIED_SAMPLER.launches == before + 2   # 1000 + 2000 samples
    ref = voc.vocode_batch(tts.last_mel_batch, [0, 2], temperature=1.0)
    for i, w in enumerate(wavs):
        assert w.size == 3000 and np.array_equal(w, ref[i])


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_unconditioned_kernel_matches_plain(cuda, temperature):
    """M = 0 (``simple_wavenet`` at tiny widths, no lc, no speakers)."""
    net = WaveNet(load_config("simple_wavenet").parse(
        "dilations_length=3,dilations_depth=2,residual_channels=8,"
        "dilation_channels=8,skip_channels=16,quantization_channels=64"))
    params = tree_to(net.init(0), cuda)
    gen = CudaWaveNetGenerator(net, params)
    codes = gen(200, seed=3, batch=2, temperature=temperature)
    gap, _ = score_gap(net, params, gen.chunk_carry0(2), codes, None, None, 3,
                       temperature)
    assert gap <= 1e-4


@pytest.mark.gpu
def test_batch_beyond_resident_clusters(cuda):
    """Full width, one stream more than the card runs at once (at least
    17): the streams run in waves and each is held to the plain version."""
    net = WaveNet(load_config("wavenet").parse(
        "lc_channels=80,gc_channels=16,gc_category_cardinality=4"))
    params = tree_to(net.init(0), cuda)
    gen = CudaWaveNetGenerator(net, params)
    batch = max(17, wavenet_gen.SAMPLER.max_active_clusters(gen.packed) + 1)
    n = 24
    lc = torch.rand(batch, n, 80, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    codes = gen(n, seed=5, batch=batch, lc=lc, temperature=1.0)
    gap, _ = score_gap(net, params, gen.chunk_carry0(batch), codes, lc, None,
                       5, 1.0)
    assert gap <= 1e-4


@pytest.mark.gpu
def test_bad_gc_id_leaves_the_context_usable(cuda):
    """An id past the gc table raises ClientError before any launch; the
    next request on the same process runs."""
    from nspeech_tpu_torch.serving import ClientError, WaveNetVocoder

    vcfg = load_config("wavenet").parse(TINY_WN.replace("lc_channels=5",
                                                        "lc_channels=80"))
    net = WaveNet(vcfg)
    voc = WaveNetVocoder(vcfg).set_variables(net, net.init(1))
    mels = np.random.default_rng(0).random((2, 3, 80)).astype(np.float32)
    before = wavenet_gen.SAMPLER.launches
    with pytest.raises(ClientError, match="gc id 3"):
        voc.vocode_batch(mels, [0, 3])
    assert wavenet_gen.SAMPLER.launches == before
    wav = voc.vocode_batch(mels, [0, 2])
    torch.cuda.synchronize()
    assert wav.shape == (2, 750) and np.isfinite(wav).all()
    assert wavenet_gen.SAMPLER.launches == before + 1


@pytest.mark.gpu
def test_taco1_on_card_matches_cpu(cuda):
    """Tacotron-1 (bah attention, tiny widths) on the card against its own
    CPU forward on the same weights (TF32 off): mel and linear within
    1e-3, the same decoder steps; then through the vocoder."""
    from nspeech_tpu_torch.models import Tacotron1
    from nspeech_tpu_torch.serving import Synthesizer, TextToSpeech, WaveNetVocoder

    cfg = load_config("taco1").parse(
        "max_iters=6,encoder_cbhg_banks=2,post_cbhg_banks=2,attention_dim=32,"
        "decoder_dim=32,embedding_dim=32,griffin_lim_iters=2")
    model = Tacotron1(cfg)
    params, bn = model.init(0)
    ids = torch.randint(2, 60, (2, 16), generator=torch.Generator().manual_seed(0))
    lengths = torch.tensor([16, 9])
    ref = model.forward(params, bn, ids, lengths)
    got = model.forward(tree_to(params, cuda), tree_to(bn, cuda), ids.to(cuda),
                        lengths.to(cuda))
    for k in ("mel_outputs", "linear_outputs", "alignments"):
        assert (got[k].cpu() - ref[k]).abs().max().item() <= 1e-3, k
    assert torch.equal(got["decoder_steps"].cpu(), ref["decoder_steps"])
    syn = Synthesizer(cfg, text_bucket=16).set_variables(params, bn, model=model)
    vcfg = load_config("wavenet").parse(TINY_WN.replace("lc_channels=5", "lc_channels=80"))
    net = WaveNet(vcfg)
    tts = TextToSpeech(syn, WaveNetVocoder(vcfg).set_variables(net, net.init(1)))
    before = wavenet_gen.SAMPLER.launches
    wav, mel, _ = tts.synthesize("taco one on the card")
    assert wavenet_gen.SAMPLER.launches == before + 1
    assert mel.shape == (30, 80) and wav.size > 0 and np.isfinite(wav).all()


@pytest.mark.gpu
def test_dynamic_batcher_shares_launches(cuda):
    """Six concurrent callers through the DynamicBatcher over a
    TextToSpeech on the card: fewer sampler launches than requests, each
    caller gets a finite waveform."""
    import threading

    from nspeech_tpu_torch.serving import (DynamicBatcher, Synthesizer,
                                           TextToSpeech, WaveNetVocoder)

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
    tts.synthesize("warm up")              # builds the kernel, plans cuDNN
    batcher = DynamicBatcher(tts, max_batch=8, window_ms=100)
    before = wavenet_gen.SAMPLER.launches
    out = {}

    def one(i):
        out[i] = batcher.synthesize("caller number %d" % i, -1, timeout=300)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    batcher.close()
    launches = wavenet_gen.SAMPLER.launches - before
    assert sorted(out) == list(range(6))
    assert all(np.isfinite(w).all() and w.size > 0 for w, _, _ in out.values())
    assert launches == batcher.stats["batches"] < 6
    assert batcher.stats["max_batch_seen"] >= 2
