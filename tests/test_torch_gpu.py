"""Card-only tests of the port (marker ``gpu``): the CUDA sampler (one-shot,
primed and carried-state launches) against its plain PyTorch version, the
wrapper's checks, the one-shot and streaming serving paths on the card,
Tacotron-1 on the card against its CPU forward (within 1e-3, TF32 off),
concurrent callers sharing launches through the ``DynamicBatcher``, two
``StreamBatcher`` groups streaming at once on their own CUDA streams
(each caller's waveform that of its text streamed alone, bit for bit,
the pair in under 1.5x one group's wall time), and
one Tacotron-2 training step at the published widths on the card against
the same step on the CPU (``chip_smoke.step_agreement``: in float32 the
loss within 1e-4 relative, the gradient, ``grad_norm``, Adam's update and
the EMA within 3e-3 relative in 2-norm, each leaf within 0.1 of its
largest entry, a relu or an L1 residual within float32 rounding of 0
passing its gradient on one device only; in float64 each leaf within
1e-9 of its largest entry, a conv bias that feeds batch norm measured
against its kernel's gradient), and one WaveNet training step at the
vocoder recipe's widths on one window the same way
(``chip_smoke.wavenet_agreement``, its tolerances ``WN_*`` there). They
skip without a CUDA device.

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

import contextlib

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
def test_stream_batcher_overlaps_groups_on_their_own_streams(cuda):
    """Two requests through ``StreamBatcher(max_batch=1)``, a group each,
    stream at once, each on its own CUDA stream and sampler cluster at the
    vocoder's published widths (~0.7 s of sampler a group): each caller
    gets the waveform of its text streamed alone on the default stream,
    bit for bit, and the pair takes under 1.5x one group's wall time."""
    import threading
    import time

    from nspeech_tpu_torch.serving import (StreamBatcher, StreamingTTS,
                                           Synthesizer, WaveNetVocoder)

    cfg = load_config("taco2").parse(
        "max_iters=24,outputs_per_step=2,encoder_conv_layers=1,"
        "postnet_conv_layers=2,postnet_conv_width=3,expand_conv_layers=1,"
        "encoder_conv_channels=16,attention_dim=16,postnet_conv_channels=16,"
        "expand_conv_channels=16,decoder_lstm_units=16,encoder_lstm_units=8,"
        "expand_lstm_units=8,embedding_dim=16")
    model = Tacotron2(cfg)
    params, bn = model.init(0)
    syn = Synthesizer(cfg, text_bucket=16).set_variables(params, bn, model=model)
    vcfg = load_config("wavenet").parse("lc_channels=80")
    net = WaveNet(vcfg)
    voc = WaveNetVocoder(vcfg).set_variables(net, net.init(1))
    tts = StreamingTTS(syn, voc, chunk_frames=8, temperature=1.0, text_bucket=16)
    texts = ["the first caller's text", "and a second caller"]
    alone = [tts.synthesize(t) for t in texts]       # also builds and plans
    batcher = StreamBatcher(tts, max_batch=1, window_ms=1)

    def timed(ts):
        out = {}

        def one(i, t):
            out[i] = np.concatenate(list(batcher.stream(t, timeout=300)))

        threads = [threading.Thread(target=one, args=(i, t)) for i, t in enumerate(ts)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
        return time.perf_counter() - t0, out

    try:
        one_s, single = timed(texts[:1])
        pair_s, pair = timed(texts)
    finally:
        batcher.close()
        batcher._worker.join(timeout=30)
    assert alone[0].size == 24 * 2 * 250
    assert np.array_equal(single[0], alone[0])
    assert all(np.array_equal(pair[i], alone[i]) for i in range(2))
    assert batcher.stats["batches"] == 3
    assert pair_s < 1.5 * one_s, (pair_s, one_s)


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


@pytest.mark.gpu
@pytest.mark.parametrize("data", ["corpus", "random"])
def test_train_step_on_card_matches_cpu(cuda, tmp_path, data):
    """``chip_smoke.py``'s check, one Tacotron-2 step at the published
    widths, no dropout: on the 4 shortest utterances of its synthetic
    corpus, and on a batch of random symbols and random targets."""
    from chip_smoke import card_vs_cpu_step, random_batch, step_agreement, write_corpus
    from nspeech_tpu_torch.data.corpus import load_items
    from nspeech_tpu_torch.data.feeder import DataFeeder

    if data == "corpus":
        items = load_items({"ljspeech": write_corpus(str(tmp_path / "corpus"))})
        cfg = load_config("taco2").parse("batch_size=4,batch_group_size=1")
        batch = next(DataFeeder(items[:4], cfg).epoch_batches(0))
    else:
        batch = random_batch(0)
    good, line = step_agreement(card_vs_cpu_step(batch))
    assert good, line


@pytest.mark.gpu
def test_wavenet_train_step_on_card_matches_cpu(cuda, tmp_path):
    """``chip_smoke.py``'s check of the vocoder's step: one window of the
    synthetic corpus at the recipe's widths, batch 1."""
    from chip_smoke import (WN_CHECK_WINDOW, wavenet_agreement, wavenet_card_vs_cpu,
                            wavenet_cfg, write_corpus)
    from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder

    corpus = write_corpus(str(tmp_path / "corpus"), n=4)
    cfg = wavenet_cfg(f",batch_size=1,sample_size={WN_CHECK_WINDOW}")
    batch = next(WaveNetFeeder({"ljspeech": corpus}, WaveNet(cfg).receptive_field,
                               cfg).batches())
    good, line = wavenet_agreement(wavenet_card_vs_cpu(batch))
    assert good, line


@pytest.mark.gpu
def test_registered_operator_launches_the_kernel(cuda):
    """``nspeech::wavenet_sample`` (the sampler of exported vocoder
    programs) on CUDA tensors is one launch of the kernel, with the codes
    of ``CudaWaveNetGenerator`` for the same weights, speakers and seed."""
    from nspeech_tpu_torch.ops.cuda import wavenet_op

    net = WaveNet(load_config("wavenet").parse(TINY_WN))
    params = tree_to(net.init(0), cuda)
    args = wavenet_op.operator_args(net, params, [0, 2])
    lc = torch.rand(2, 200, 5, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = wavenet_gen.SAMPLER.launches
    codes = torch.ops.nspeech.wavenet_sample(
        args["packed"], args["weights"], lc, torch.tensor(3, device=cuda), 1.0,
        args["net_config"], args["weights_spec"], args["gc_ids"])
    assert wavenet_gen.SAMPLER.launches == before + 1
    ref = CudaWaveNetGenerator(net, params, gc_ids=[0, 2])(200, seed=3, batch=2,
                                                          lc=lc)
    assert torch.equal(codes, ref)


# -- the Tacotron train step as CUDA graphs (train/loop.py CudaGraphSteps) ----

TINY_T2 = ("encoder_conv_layers=2,postnet_conv_layers=2,expand_conv_layers=2,"
           "encoder_conv_channels=32,attention_dim=32,postnet_conv_channels=32,"
           "expand_conv_channels=32,decoder_lstm_units=32,encoder_lstm_units=16,"
           "expand_lstm_units=16,embedding_dim=32,ema_decay=0.99")
TINY_T1 = ("encoder_cbhg_banks=2,post_cbhg_banks=2,attention_dim=32,decoder_dim=32,"
           "embedding_dim=32,ema_decay=0.99")
# padded (T_in, T_out) of the steps, in turn: shapes A, B, A, C, B, A
GRAPH_SHAPES = [(16, 40), (32, 60), (16, 40), (16, 80), (32, 60), (16, 40)]


def graph_batch(seed, t_in, t_out, rows=4):
    """A feeder batch of random symbols and targets, zero past each row's
    lengths, on the card."""
    from nspeech_tpu_torch.data.feeder import Batch
    from nspeech_tpu_torch.train.loop import batch_to_device

    rng = np.random.default_rng(seed)
    lengths = rng.integers(t_in // 2, t_in + 1, rows)
    lengths[0] = t_in
    frames = rng.integers(t_out // 2, t_out + 1, rows)
    ids = rng.integers(2, 60, (rows, t_in))
    ids[np.arange(t_in)[None] >= lengths[:, None]] = 0
    mel = rng.random((rows, t_out, 80), dtype=np.float32)
    lin = rng.random((rows, t_out, 1025), dtype=np.float32)
    mel[np.arange(t_out)[None] >= frames[:, None]] = 0.0
    lin[np.arange(t_out)[None] >= frames[:, None]] = 0.0
    return batch_to_device(Batch(ids, lengths, np.zeros(rows, np.int64), mel, lin,
                                 np.zeros((rows, 0), np.float32)), "cuda")


def graph_run(step, model, opt, batches, on_step=None):
    """Steps over ``batches`` from the state of init seed 0, each with the
    runner's generator; returns each step's metrics and state on the host
    (a graphed step donates its state: the next step overwrites it)."""
    from nspeech_tpu_torch.train.loop import create_state, step_generator

    state = create_state(model, opt, 0, ema=True, device="cuda")
    out = []
    for k, batch in enumerate(batches):
        state, metrics = step(state, batch, step_generator("cuda", 7, k))
        if on_step is not None:
            on_step(k, metrics)
        out.append(host_tree({"metrics": {n: v for n, v in metrics.items()
                                          if isinstance(v, torch.Tensor)},
                              "params": state.params, "bn": state.bn_state,
                              "mu": state.opt_state["mu"],
                              "nu": state.opt_state["nu"], "ema": state.ema_params}))
    return out


def host_tree(tree):
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [host_tree(v) for v in tree]
    return tree.detach().to("cpu", copy=True)


def worst_gaps(a, b):
    """Per part (metrics, params, bn, mu, nu, ema): the largest absolute
    difference of any entry over every step of two runs (0 for a part
    with no leaves, a WaveNet's batch-norm state)."""
    from nspeech_tpu_torch.utils.tree import tree_leaves

    return {part: max((float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
                       for sa, sb in zip(a, b)
                       for x, y in zip(tree_leaves(sa[part]), tree_leaves(sb[part]))),
                      default=0.0)
            for part in a[0]}


def graph_setup(extra="", name="taco2"):
    from nspeech_tpu_torch.models import Tacotron1
    from nspeech_tpu_torch.train.optim import make_optimizer

    cfg = load_config(name).parse({"taco1": TINY_T1, "taco2": TINY_T2}[name] + extra)
    model = {"taco1": Tacotron1, "taco2": Tacotron2}[name](cfg)
    opt, sched = make_optimizer(cfg, name)
    return cfg, model, opt, sched


def graph_gaps_within_eager(build, model, opt, batches, on_step=None):
    """Two eager runs and one graphed run over ``batches``, from one
    state; asserts that the graphed run's worst gap to the first eager
    run is within the two eager runs' own, part by part (bit for bit
    where they agree). Returns the graphed step and its run."""
    eager = [graph_run(build().graphs.step, model, opt, batches) for _ in range(2)]
    step = build()
    graphed = graph_run(step, model, opt, batches, on_step)
    between_eager = worst_gaps(eager[0], eager[1])
    for k in range(len(batches)):
        print(f"step {k}: eager vs eager {worst_gaps(eager[0][k:k + 1], eager[1][k:k + 1])}"
              f", graphed vs eager {worst_gaps(eager[0][k:k + 1], graphed[k:k + 1])}")
    for part, gap in worst_gaps(eager[0], graphed).items():
        assert gap <= between_eager[part], (part, gap, between_eager[part])
    return step, graphed


@pytest.mark.gpu
@pytest.mark.parametrize("name,extra,deferred_dw", [
    ("taco2", "", None),
    ("taco2", ",scheduled_sampling_ratio=0.3", None),
    ("taco2", ",compute_dtype=bfloat16", None),
    ("taco2", "", False),
    ("taco1", "", None),
], ids=["taco2", "taco2-scheduled-sampling", "taco2-bf16", "taco2-autograd-dw",
        "taco1"])
def test_graphed_train_step_equals_eager(cuda, name, extra, deferred_dw, monkeypatch):
    """Over the padded shapes A, B, A, C, B, A, with prenet dropout (and
    scheduled sampling) drawn from the runner's generators, for Tacotron-2
    (float32, bf16 compute, weight gradients deferred or from autograd)
    and Tacotron-1 (its GRU decoder): the graphed step's losses,
    grad_norms, params, Adam's moments, batch-norm state and EMA equal
    the eager step's within what two eager runs differ by (bit for bit
    when they agree: cuDNN's deterministic algorithms, so that its weight
    gradients sum in one order); each shape's first step eager, its
    second captured (A and B; C, seen once, never), the last a replay
    alone; a step's metrics unchanged by the next step."""
    from nspeech_tpu_torch.train.loop import build_tacotron_train_step, shape_key

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg, model, opt, sched = graph_setup(extra, name)
    batches = [graph_batch(k, *s) for k, s in enumerate(GRAPH_SHAPES)]
    kept = {}

    def check_kept(k, metrics):
        if k:
            for n, (held, copy) in kept.items():
                assert torch.equal(held, copy), f"step {k - 1}'s {n} changed"
        kept.clear()
        kept.update({n: (v, v.clone()) for n, v in metrics.items()
                     if isinstance(v, torch.Tensor)})

    step, graphed = graph_gaps_within_eager(
        lambda: build_tacotron_train_step(model, opt, sched, cfg.ema_decay,
                                          deferred_dw=deferred_dw),
        model, opt, batches, check_kept)
    # steps 0, 1 and 3 run eagerly; 2 and 4 capture A and B; 5 replays A
    # keyed by the batches' shapes, with a generator
    assert sorted(step.graphs.graphs) == sorted(shape_key(batches[k], True) for k in (0, 1))
    assert step.graphs.seen == {shape_key(b, True) for b in batches}
    losses = [s["metrics"]["loss"].item() for s in graphed]
    assert len(set(losses)) == len(losses) and all(np.isfinite(losses))


@pytest.mark.gpu
def test_graphed_train_step_at_published_widths_equals_eager(cuda, monkeypatch):
    """Tacotron-2 at the published widths (the ``t2wn.train`` cell's, TF32
    off as the cell runs) at batch 32 and one padded shape the cell's
    corpus meets, (T_in, T_out) = (160, 800): an eager step, the step
    that captures and replays, and a replay, each on its own batch,
    equal to two eager runs' steps within what those differ by (bit for
    bit when they agree, under cuDNN's deterministic algorithms)."""
    from nspeech_tpu_torch.train.loop import build_tacotron_train_step, shape_key
    from nspeech_tpu_torch.train.optim import make_optimizer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = load_config("taco2")
    model = Tacotron2(cfg)
    opt, sched = make_optimizer(cfg, "taco2")
    batches = [graph_batch(k, 160, 800, rows=cfg.batch_size) for k in range(3)]
    step, _ = graph_gaps_within_eager(
        lambda: build_tacotron_train_step(model, opt, sched, cfg.ema_decay),
        model, opt, batches)
    assert list(step.graphs.graphs) == [shape_key(batches[0], True)]
    assert batches[0].mel_targets.shape[:2] == (cfg.batch_size, 800)


@pytest.mark.gpu
def test_graphed_train_step_draws_the_eager_masks(cuda, monkeypatch):
    """Every random draw of a replay (the prenet's dropout masks, the
    scheduled-sampling coins) equals the eager step's from a generator
    seeded the same way: the draws are copied, as they are made, into a
    buffer outside the graphs' pool, which each replay writes anew."""
    from nspeech_tpu_torch.parallel import collectives
    from nspeech_tpu_torch.train.loop import build_tacotron_train_step

    cfg, model, opt, sched = graph_setup(",scheduled_sampling_ratio=0.3")
    batches = [graph_batch(k, *s) for k, s in enumerate(GRAPH_SHAPES)]
    record = torch.zeros(1 << 20, device=cuda)
    cursor = [0]
    rand_rows = collectives.rand_rows

    def recorded(shape, generator, device):
        x = rand_rows(shape, generator, device)
        record[cursor[0]:cursor[0] + x.numel()].copy_(x.reshape(-1))
        cursor[0] += x.numel()
        return x

    monkeypatch.setattr(collectives, "rand_rows", recorded)
    draws, counts = {}, []
    for mode in ("eager", "graphed"):
        step = build_tacotron_train_step(model, opt, sched, cfg.ema_decay)
        if mode == "eager":
            step = step.graphs.step

        def keep(k, metrics, mode=mode):
            # a replay makes no Python call: the eager step's count of
            # draws says how much of the buffer the replay wrote
            if mode == "eager":
                counts.append(cursor[0])
            draws[mode, k] = record[:counts[k]].cpu()
            assert not record[counts[k]:].any()
            cursor[0] = 0
            record.zero_()

        graph_run(step, model, opt, batches, keep)
    for k in range(len(GRAPH_SHAPES)):
        assert counts[k] > 0
        assert torch.equal(draws["graphed", k], draws["eager", k]), k
    assert not torch.equal(draws["eager", 0], draws["eager", 2])   # other seeds


@contextlib.contextmanager
def one_rank(device):
    """A ``parallel.mesh.DataParallel`` of one rank over NCCL."""
    import socket

    import torch.distributed as dist

    from nspeech_tpu_torch.parallel.mesh import DataParallel

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield DataParallel(0, 1, device)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_data_parallel_train_step_stays_eager(cuda):
    """A step with ``dp`` (one rank over NCCL) runs the eager step: no
    graph, no static state, and the plain step's loss."""
    from nspeech_tpu_torch.train.loop import build_tacotron_train_step

    cfg, model, opt, sched = graph_setup()
    with one_rank(cuda) as dp:
        step = build_tacotron_train_step(model, opt, sched, cfg.ema_decay, dp=dp)
        batches = [graph_batch(0, *GRAPH_SHAPES[0])] * 2
        got = graph_run(step, model, opt, batches)
        assert step.graphs.static is None and not step.graphs.graphs
    plain = graph_run(build_tacotron_train_step(model, opt, sched, cfg.ema_decay).graphs.step,
                      model, opt, batches)
    assert [r["metrics"]["loss"].item() for r in got] == pytest.approx(
        [r["metrics"]["loss"].item() for r in plain], rel=1e-5)


# -- the WaveNet train step as a CUDA graph (train/loop.py, one shape a run) ---

WN_GRAPH = TINY_WN + ",sample_size=512,batch_size=3"
WN_PUBLISHED = ("lc_channels=80,gc_channels=0,gc_category_cardinality=0,"
                "sample_size=20480,batch_size=4,ema_decay=0,l2_regularization_strength=0")


def wavenet_graph_batch(seed, cfg, per_sample=False, ids=None):
    """``cfg.batch_size`` random windows of the receptive field +
    ``sample_size`` samples on the card, with mels as the feeder ships
    them (frame rows and each window's phase) or per sample (the GTA
    layout, no phase), and random speakers (or ``ids``)."""
    from nspeech_tpu_torch.config import stft_params
    from nspeech_tpu_torch.data.wavenet_feeder import WaveNetBatch
    from nspeech_tpu_torch.train.loop import wavenet_batch_to_device

    rng = np.random.default_rng(seed)
    rows, width = cfg.batch_size, cfg.lc_channels
    window = WaveNet(cfg).receptive_field + cfg.sample_size
    hop = stft_params(cfg)[1]
    if per_sample:
        mel, phase = rng.random((rows, window, width), dtype=np.float32), None
    else:
        mel = rng.random((rows, (window + hop - 2) // hop + 2, width), dtype=np.float32)
        phase = rng.integers(0, hop, rows).astype(np.int32)
    if ids is None:
        ids = rng.integers(0, max(1, cfg.gc_category_cardinality), rows)
    return wavenet_batch_to_device(WaveNetBatch(
        rng.uniform(-0.9, 0.9, (rows, window)).astype(np.float32),
        np.asarray(ids, np.int32), mel, phase), "cuda")


def wavenet_graphs_equal_eager(cfg, batches, monkeypatch, use_gc=False, bad=None):
    """:func:`graph_gaps_within_eager` for the WaveNet step with lc over
    ``batches`` (one shape: eager, capture, then replays); with ``bad``, a
    batch with a speaker id outside the table, the graphed run first
    tries it at every step: it raises and nothing is captured or
    replayed. Asserts one graph, keyed by the batches' shapes, replayed
    from the second step on; returns the graphed run."""
    from nspeech_tpu_torch.train.loop import build_wavenet_train_step, shape_key
    from nspeech_tpu_torch.train.optim import make_optimizer

    net = WaveNet(cfg)
    opt, sched = make_optimizer(cfg, "wavenet")
    replays = []
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        replays.append(graph)
        return replay(graph)

    def build():
        step = build_wavenet_train_step(net, opt, cfg, sched, use_gc=use_gc, use_lc=True,
                                        ema_decay=cfg.ema_decay)
        if bad is None:
            return step

        def probed(state, batch, generator=None):
            before = (len(replays), len(step.graphs.graphs))
            with pytest.raises(ValueError, match="outside"):
                step(state, bad)
            assert (len(replays), len(step.graphs.graphs)) == before
            return step(state, batch, generator)

        probed.graphs = step.graphs
        return probed

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", counted)
    step, graphed = graph_gaps_within_eager(build, net, opt, batches)
    assert list(step.graphs.graphs) == [shape_key(batches[0], None)]
    assert len(replays) == len(batches) - 1
    losses = [s["metrics"]["loss"].item() for s in graphed]
    assert len(set(losses)) == len(losses) and all(np.isfinite(losses))
    return graphed


@pytest.mark.gpu
@pytest.mark.parametrize("extra,per_sample,use_gc", [
    ("", False, False),
    ("", True, False),
    (",ema_decay=0.99", False, False),
    ("", False, True),
], ids=["frame-rate-mels", "per-sample-mels", "ema", "gc"])
def test_graphed_wavenet_step_equals_eager(cuda, extra, per_sample, use_gc, monkeypatch):
    """The vocoder's step as a CUDA graph over four batches of one shape
    (an eager step, the step that captures and replays, two replays):
    the losses, grad_norms, params, Adam's moments and EMA equal two eager
    runs' within what those differ by (bit for bit when they agree, under
    cuDNN's deterministic algorithms), with frame-rate mels and their
    phase, with per-sample mels (the GTA layout), with an EMA, and with
    gc, where a speaker id outside the table raises before the graph runs
    as it does in the eager step."""
    cfg = load_config("wavenet").parse(WN_GRAPH + extra)
    batches = [wavenet_graph_batch(k, cfg, per_sample) for k in range(4)]
    bad = None
    if use_gc:
        bad = wavenet_graph_batch(9, cfg, per_sample, ids=[0, cfg.gc_category_cardinality, 1])
    graphed = wavenet_graphs_equal_eager(cfg, batches, monkeypatch, use_gc, bad)
    if extra:
        assert not torch.equal(graphed[-1]["ema"]["post2"][0], graphed[0]["ema"]["post2"][0])


@pytest.mark.gpu
def test_graphed_wavenet_step_at_published_widths_equals_eager(cuda, monkeypatch):
    """The ``wavenet_vocoder`` configuration's step (50 layers, lc 80,
    batch 4, windows of 5,117 + 20,480 = 25,597 samples, TF32 off as the
    ``wavenet.train`` cell runs): an eager step, a capture, two replays,
    equal to two eager runs' steps within what those differ by."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = load_config("wavenet").parse(WN_PUBLISHED)
    batches = [wavenet_graph_batch(k, cfg) for k in range(4)]
    assert batches[0].audio.shape == (4, 25597)
    wavenet_graphs_equal_eager(cfg, batches, monkeypatch)


@pytest.mark.gpu
def test_graphed_wavenet_step_captures_when_the_cache_holds_the_card(cuda):
    """After the eager first step the card's memory is taken into the
    caching allocator and freed there (as another model's training in the
    same process leaves it): the capture, which cannot release cached
    blocks to the card while it runs, still gets its pool, and the
    replays give the eager steps' losses."""
    from nspeech_tpu_torch.train.loop import build_wavenet_train_step
    from nspeech_tpu_torch.train.optim import make_optimizer

    cfg = load_config("wavenet").parse(WN_GRAPH)
    net = WaveNet(cfg)
    opt, sched = make_optimizer(cfg, "wavenet")
    batches = [wavenet_graph_batch(k, cfg) for k in range(3)]

    def hold_the_card(k, metrics):
        if k:
            return
        held = []
        for size in (1 << 30, 1 << 25, 1 << 20):     # the last in 2 MB segments
            with contextlib.suppress(torch.OutOfMemoryError):
                while True:
                    held.append(torch.empty(size, dtype=torch.uint8, device=cuda))
        del held
        assert torch.cuda.mem_get_info()[0] < 1 << 22

    try:
        step = build_wavenet_train_step(net, opt, cfg, sched, use_lc=True)
        graphed = graph_run(step, net, opt, batches, hold_the_card)
        assert len(step.graphs.graphs) == 1
    finally:
        torch.cuda.empty_cache()
    eager = graph_run(step.graphs.step, net, opt, batches)
    assert [s["metrics"]["loss"].item() for s in graphed] == pytest.approx(
        [s["metrics"]["loss"].item() for s in eager], rel=1e-6)


@pytest.mark.gpu
def test_data_parallel_wavenet_step_stays_eager(cuda):
    """A vocoder step with ``dp`` (one rank over NCCL) runs the eager
    step: no graph, no static state, and the plain step's loss."""
    from nspeech_tpu_torch.train.loop import build_wavenet_train_step
    from nspeech_tpu_torch.train.optim import make_optimizer

    cfg = load_config("wavenet").parse(WN_GRAPH)
    net = WaveNet(cfg)
    opt, sched = make_optimizer(cfg, "wavenet")
    batches = [wavenet_graph_batch(0, cfg)] * 2
    with one_rank(cuda) as dp:
        step = build_wavenet_train_step(net, opt, cfg, sched, use_lc=True, dp=dp)
        got = graph_run(step, net, opt, batches)
        assert step.graphs.static is None and not step.graphs.graphs
    plain = graph_run(build_wavenet_train_step(net, opt, cfg, sched, use_lc=True).graphs.step,
                      net, opt, batches)
    assert [r["metrics"]["loss"].item() for r in got] == pytest.approx(
        [r["metrics"]["loss"].item() for r in plain], rel=1e-5)
