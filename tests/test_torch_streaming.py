"""The port's streaming path against the JAX package's, on the CPU at tiny
widths: the carried-state generator (the plain version of the sampler's
carried form), the chunked decoder, the halo'd postnet windows, the
absolute-position upsample and ``StreamingTTS`` end to end (with
Tacotron-2 and with Tacotron-1).

Tolerances: codes identical at temperature 0 (argmax with the
lowest-index tie-break on both sides) and, at temperature 1, identical
between the port's own chained and one-shot generation (same Philox noise
at the same absolute sample). Decoder outputs within 1e-7 and steps
exact, as the one-shot decoder test. Windowed postnet within 1e-6 of the
port's full-buffer postnet (the same float32 convs over other lengths) and
1e-4 of JAX's. Stream waveforms within 1e-6 of JAX's (identical codes,
float32 mu-law decode), mels within 1e-4 of JAX's; against the port's own
one-shot path the waveform is identical and the mel within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models import create_model
from nspeech_tpu.models import decoder as JD
from nspeech_tpu.serving import Synthesizer as JSynth
from nspeech_tpu.serving import WaveNetVocoder as JVoc
from nspeech_tpu.serving.streaming import StreamingTTS as JStream
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models import Tacotron2, WaveNet
from nspeech_tpu_torch.models import create_model as t_create
from nspeech_tpu_torch.models import decoder as TD
from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
from nspeech_tpu_torch.ops.upsample import upsample_abs, upsample_on_device
from nspeech_tpu_torch.serving import ClientError, StreamingTTS
from nspeech_tpu_torch.serving import Synthesizer as TSynth
from nspeech_tpu_torch.serving import WaveNetVocoder as TVoc

torch.set_num_threads(1)

WN = ("dilations_length=3,dilations_depth=2,residual_channels=8,"
      "dilation_channels=8,skip_channels=16,quantization_channels=64,"
      "lc_channels=5,gc_channels=4,gc_category_cardinality=3")
TACO = ("max_iters=6,outputs_per_step=2,encoder_conv_layers=1,"
        "postnet_conv_layers=2,postnet_conv_width=3,expand_conv_layers=1,"
        "encoder_conv_channels=16,attention_dim=16,postnet_conv_channels=16,"
        "expand_conv_channels=16,decoder_lstm_units=16,encoder_lstm_units=8,"
        "expand_lstm_units=8,embedding_dim=16,griffin_lim_iters=1,"
        "num_speakers=3")
TACO1 = ("max_iters=6,outputs_per_step=2,encoder_cbhg_banks=2,post_cbhg_banks=2,"
         "attention_dim=16,decoder_dim=16,embedding_dim=16,griffin_lim_iters=1,"
         "num_speakers=3")
VOC = ("dilations_length=3,dilations_depth=1,residual_channels=8,"
       "dilation_channels=8,skip_channels=16,quantization_channels=64,"
       "lc_channels=80,gc_channels=4,gc_category_cardinality=3")
TEXTS = ["hello world", "a very different input line", "hi"]


# -- (a) the carried-state generator ------------------------------------------

@pytest.fixture(scope="module")
def wavenets():
    jnet = create_model("wavenet", j_load("wavenet").parse(WN))
    tnet = WaveNet(t_load("wavenet").parse(WN))
    jparams = jnet.init(jax.random.PRNGKey(1))
    tparams = convert.wavenet_params(
        tnet, jax.tree_util.tree_map(np.asarray, jparams))
    lc = np.random.default_rng(0).random((2, 48, 5)).astype(np.float32)
    return jnet, jparams, tnet, tparams, lc


def chained(gen, carry, lc, sizes, temperature, seed=5):
    outs, start = [], 0
    for n in sizes:
        codes, carry = gen(carry, n, lc[:, start:start + n], temperature, seed)
        outs.append(np.asarray(codes))
        start += n
    return np.concatenate(outs, axis=1), carry


@pytest.mark.parametrize("sizes", [(7, 16, 1, 24), (48,)])
def test_generate_chunk_matches_jax_at_argmax(wavenets, sizes):
    jnet, jparams, tnet, tparams, lc = wavenets
    gc = np.array([2, 0], np.int32)
    ref = np.asarray(jnet.generate(jparams, 48, jax.random.PRNGKey(5), batch=2,
                                   gc_ids=jnp.asarray(gc), lc=jnp.asarray(lc),
                                   temperature=0.0))

    def jgen(carry, n, lc_n, temperature, seed):
        return jnet.generate_chunk(jparams, carry, n, jax.random.PRNGKey(seed),
                                   gc_ids=jnp.asarray(gc),
                                   lc=jnp.asarray(lc_n), temperature=temperature)

    def tgen(carry, n, lc_n, temperature, seed):
        return tnet.generate_chunk(tparams, carry, n, seed=seed, gc_ids=gc,
                                   lc=torch.from_numpy(lc_n),
                                   temperature=temperature)

    j, _ = chained(jgen, jnet.generate_carry0(batch=2), lc, sizes, 0.0)
    t, carry = chained(tgen, tnet.generate_carry0(2), lc, sizes, 0.0)
    np.testing.assert_array_equal(j, ref)
    np.testing.assert_array_equal(t, ref)
    assert carry[0] == 48 and carry[3].shape == (2, sum(tnet.dilations), 8)
    np.testing.assert_array_equal(carry[1].numpy(), ref[:, -1])
    np.testing.assert_array_equal(carry[2].numpy(), ref[:, -2])


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_wrapper_chunks_equal_one_shot(wavenets, temperature):
    """CudaWaveNetGenerator.generate_chunk on CPU tensors (its plain
    version): chained chunks of uneven sizes equal one call, at every
    temperature; the input carry is left as it was, so resuming twice
    from it repeats; ``final=True`` returns no carry."""
    _, _, tnet, tparams, lc = wavenets
    lc_t = torch.from_numpy(lc)
    gen = CudaWaveNetGenerator(tnet, tparams, gc_ids=[1, 2])
    ref = gen(48, seed=5, batch=2, lc=lc_t, temperature=temperature).numpy()

    def wgen(carry, n, lc_n, temperature, seed):
        return gen.generate_chunk(carry, n, seed=seed,
                                  lc=torch.from_numpy(lc_n),
                                  temperature=temperature)

    codes, _ = chained(wgen, gen.chunk_carry0(2), lc, (7, 16, 1, 24),
                       temperature)
    np.testing.assert_array_equal(codes, ref)
    mid, _ = chained(wgen, gen.chunk_carry0(2), lc, (7, 16), temperature)
    _, carry = gen.generate_chunk(gen.chunk_carry0(2), 23, seed=5,
                                  lc=lc_t[:, :23], temperature=temperature)
    before = [carry[0]] + [v.clone() for v in carry[1:]]
    a, _ = gen.generate_chunk(carry, 25, seed=5, lc=lc_t[:, 23:],
                              temperature=temperature)
    b, last = gen.generate_chunk(carry, 25, seed=5, lc=lc_t[:, 23:],
                                 temperature=temperature, final=True)
    assert carry[0] == before[0] and last is None
    for v, w in zip(carry[1:], before[1:]):
        assert torch.equal(v, w)
    np.testing.assert_array_equal(np.concatenate([mid, a.numpy()], 1), ref)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- (b) the chunked decoder --------------------------------------------------

RATES = np.array([0.3, 0.6, 0.75, 0.5], np.float32)
RAMP = np.linspace(0.2, 1.0, 6, dtype=np.float32)


def jstep(c, x, _rng):
    out = c[:, None] * RAMP[None, :] + 0.0 * x.sum(-1, keepdims=True)
    return c * RATES, (out, jnp.tile(c[:, None], (1, 5)))


def tstep(c, x):
    out = c[:, None] * torch.from_numpy(RAMP)[None, :] + 0.0 * x.sum(-1, keepdim=True)
    return c * torch.from_numpy(RATES), (out, c[:, None].repeat(1, 5))


@pytest.mark.parametrize("chunks", [(4, 6, 9), (1, 1, 17), (19,)])
def test_decoder_chunks_match_jax(chunks):
    """Rows stop at steps 5, 9 and 15 of 20, a padding row starts
    finished: stopped rows emit zeros and, once every row has stopped,
    the alignments are zeros too."""
    init_fin = np.array([False, False, False, True])
    jo, ja, _ = JD.scan_autoregressive(
        jstep, jnp.ones(4), 4, 3, 2, 20, stop_threshold=0.02,
        initial_finished=jnp.asarray(init_fin))
    (o0, a0), jc = JD.start_autoregressive(
        jstep, jnp.ones(4), 4, 3, 20, stop_threshold=0.02,
        initial_finished=jnp.asarray(init_fin))
    (t0, ta0), tc = TD.start_autoregressive(
        tstep, torch.ones(4), 4, 3, 20, stop_threshold=0.02,
        initial_finished=torch.from_numpy(init_fin))
    jouts, jal, touts, tal = [o0[None]], [a0[None]], [t0[None]], [ta0[None]]
    for k in chunks:
        (o, a), jc = JD.scan_autoregressive_chunk(jstep, jc, k, 3,
                                                  stop_threshold=0.02)
        jouts.append(o)
        jal.append(a)
        (o, a), tc = TD.scan_autoregressive_chunk(tstep, tc, k, 3,
                                                  stop_threshold=0.02)
        touts.append(o)
        tal.append(a)
    j_o, t_o = np.concatenate(jouts), torch.cat(touts).numpy()
    j_a, t_a = np.concatenate(jal), torch.cat(tal).numpy()
    np.testing.assert_allclose(t_o, j_o, atol=1e-7)
    np.testing.assert_allclose(t_a, j_a, atol=1e-7)
    np.testing.assert_allclose(t_o, np.asarray(jo), atol=1e-7)
    np.testing.assert_allclose(t_a, np.asarray(ja), atol=1e-7)
    assert tc[4].tolist() == np.asarray(jc[4]).tolist() == [5, 9, 15, 0]
    assert tc[0] == 20 and bool(tc[3].all())
    assert not t_a[15:].any() and t_a[14].any()   # the all-finished tail


# -- (c) the postnet on halo'd windows ----------------------------------------

def test_postnet_windows_match_full_buffer():
    jcfg, tcfg = j_load("taco2").parse(TACO), t_load("taco2").parse(TACO)
    jm = create_model("taco2", jcfg)
    jp, js = jm.init(jax.random.PRNGKey(0))
    tm = Tacotron2(tcfg)
    tp, ts = convert.tacotron2_variables(
        tm, jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js))
    frames = np.random.default_rng(3).standard_normal((2, 30, 80)).astype(np.float32)
    full = tm.postnet_residual(tp, ts, torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(
        full, np.asarray(jm.postnet_residual(jp, js, jnp.asarray(frames))),
        atol=1e-4)
    halo = 2
    for b, n in ((0, 8), (8, 8), (16, 6), (22, 8)):
        w0 = min(max(b - halo, 0), 30 - (n + 2 * halo))
        win = tm.postnet_residual(
            tp, ts, torch.from_numpy(frames[:, w0: w0 + n + 2 * halo])).numpy()
        np.testing.assert_allclose(win[:, b - w0: b - w0 + n],
                                   full[:, b: b + n], atol=1e-6)


# -- (d) the absolute-position upsample ---------------------------------------

@pytest.mark.parametrize("s0,length", [(0, 1000), (1237, 2000), (7001, 499),
                                       (4750, 250), (9990, 37)])
def test_upsample_abs_is_sliced_upsample(s0, length):
    """Bit for bit, at unaligned starts and past the last frame."""
    hop, total = 250, 40
    mels = torch.from_numpy(
        np.random.default_rng(1).random((2, total, 80)).astype(np.float32))
    full = upsample_on_device(mels, hop, total * hop + 300)
    f0 = s0 // hop
    win = mels[:, f0: f0 + length // hop + 3]
    got = upsample_abs(win, f0, s0, hop, length, total)
    assert torch.equal(got, full[:, s0: s0 + length])


# -- (e), (f) StreamingTTS against JAX and against the port's one-shot --------

def build_systems(name, overrides):
    """JAX and port Tacotron ``name`` and vocoders on the same weights."""
    jcfg, tcfg = j_load(name).parse(overrides), t_load(name).parse(overrides)
    jm = create_model(name, jcfg)
    jp, js = jm.init(jax.random.PRNGKey(0))
    tm = t_create(name, tcfg)
    tp, ts = convert.tacotron_variables(
        tm, jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js))
    jvcfg, tvcfg = j_load("wavenet").parse(VOC), t_load("wavenet").parse(VOC)
    jnet = create_model("wavenet", jvcfg)
    jvp = jnet.init(jax.random.PRNGKey(1))
    tnet = WaveNet(tvcfg)
    tvp = convert.wavenet_params(tnet, jax.tree_util.tree_map(np.asarray, jvp))
    return ((jm, jp, js, jnet, jvp, jcfg, jvcfg),
            (tm, tp, ts, tnet, tvp, tcfg, tvcfg))


@pytest.fixture(scope="module")
def systems():
    return build_systems("taco2", TACO)


@pytest.fixture(scope="module")
def taco1_systems():
    return build_systems("taco1", TACO1)


def stop_threshold(systems):
    """A stop threshold between the texts' per-step output peaks, so the
    streams stop at different interior steps (the JAX test's search)."""
    (jm, jp, js, *_), _ = systems
    from nspeech_tpu.text import text_to_sequence

    seqs = [text_to_sequence(t, ["english_cleaners"]) for t in TEXTS]
    ids = np.zeros((3, 32), np.int32)
    for i, sq in enumerate(seqs):
        ids[i, : len(sq)] = sq
    ctx, cell0 = jm.attention_context(jp, js, jnp.asarray(ids),
                                      jnp.asarray([len(s) for s in seqs]),
                                      jnp.asarray([0, 1, 2]))
    raw, _, _ = JD.scan_autoregressive(jm.make_eval_step(jp, ctx), cell0, 3,
                                       80, 2, max_iters=6)
    peak = np.abs(np.asarray(raw)).max(axis=2)            # [steps, rows]
    vals = sorted(set(peak.ravel().tolist()))
    for lo, hi in zip(vals, vals[1:]):
        c = (lo + hi) / 2.0
        stops = [int(np.argmax(peak[:, i] <= c)) if (peak[:, i] <= c).any()
                 else 6 for i in range(3)]
        if len(set(stops)) > 1:
            return c
    raise AssertionError("no threshold separates the streams' stops")


def make_streams(systems, extra="", temperature=0.0, growth=4, name="taco2",
                 base=TACO):
    (jm, jp, js, jnet, jvp, jcfg, jvcfg), (tm, tp, ts, tnet, tvp, tcfg, tvcfg) = systems
    jcfg, tcfg = j_load(name).parse(base + extra), t_load(name).parse(base + extra)
    jsyn = JSynth(jcfg, text_bucket=16).set_variables(jp, js, model=jm)
    jvoc = JVoc(jvcfg, use_pallas=False).set_variables(jnet, jvp)
    tsyn = TSynth(tcfg, text_bucket=16, device="cpu").set_variables(
        tp, ts, model=name)
    tvoc = TVoc(tvcfg, device="cpu").set_variables(tnet, tvp)
    kw = dict(chunk_frames=4, temperature=temperature, text_bucket=16,
              growth=growth)
    return (JStream(jsyn, jvoc, **kw), StreamingTTS(tsyn, tvoc, **kw),
            tsyn, tvoc)


def one_shot_mels(tsyn, texts, speakers):
    """The model's forward on the stream's padded batch."""
    from nspeech_tpu_torch.text import text_to_sequence

    n = max(1, 1 << (len(texts) - 1).bit_length())
    seqs = [text_to_sequence(t, ["english_cleaners"]) for t in texts]
    width = -(-max(len(s) for s in seqs) // 16) * 16
    ids = torch.zeros(n, width, dtype=torch.int64)
    lengths = torch.zeros(n, dtype=torch.int64)
    for i, sq in enumerate(seqs):
        ids[i, : len(sq)] = torch.tensor(sq)
        lengths[i] = len(sq)
    spk = torch.zeros(n, dtype=torch.int64)
    spk[: len(texts)] = torch.tensor([max(s, 0) for s in speakers])
    return tsyn.model.forward(tsyn._params, tsyn._bn_state, ids, lengths,
                              spk)["mel_outputs"].numpy()


def check_stream(systems, growth, max_iters, layout, **model):
    jst, tst, tsyn, tvoc = make_streams(systems, f",max_iters={max_iters}",
                                        growth=growth, **model)
    assert layout == ("whole" if tst._whole_postnet else
                      "prefix" if tst._use_prefix else "windows")
    jchunks = list(jst.stream("hello world"))
    tchunks = list(tst.stream("hello world"))
    assert len(tchunks) > 1
    assert [len(c) for c in tchunks] == [len(c) for c in jchunks]
    wav = np.concatenate(tchunks)
    np.testing.assert_allclose(wav, np.concatenate(jchunks), atol=1e-6)
    np.testing.assert_allclose(tst.last_mel, jst.last_mel, atol=1e-4)
    mel = one_shot_mels(tsyn, ["hello world"], [-1])[0]
    frames = 2 * max_iters
    assert tst.last_total_frames == frames
    np.testing.assert_allclose(tst.last_mel, mel[:frames], atol=1e-6)
    assert np.array_equal(wav, tvoc.vocode_batch(tst.last_mel_batch,
                                                 temperature=0.0)[0])
    assert len(tst.last_launch_to_delivery) == len(tchunks)


@pytest.mark.parametrize("growth,max_iters,layout", [
    (1, 6, "prefix"), (4, 6, "prefix"), (4, 4, "windows"), (4, 3, "whole")])
def test_stream_matches_jax_and_one_shot(systems, growth, max_iters, layout):
    """One unconditioned stream, no early stop (runs to max_iters): the
    same chunk boundaries and waveform as JAX's stream, its mel JAX's and
    the port's one-shot mel, its waveform vocode_batch of its own mel.
    The decode budget picks the postnet layout: a first-window prefix,
    windows without it, or the whole buffer at once."""
    check_stream(systems, growth, max_iters, layout)


@pytest.mark.parametrize("growth,max_iters,layout", [
    (1, 6, "prefix"), (4, 6, "prefix"), (4, 3, "windows")])
def test_taco1_stream_matches_jax_and_one_shot(taco1_systems, growth,
                                               max_iters, layout):
    """The same with Tacotron-1: no postnet, so no halo; its decoder
    frames are the mel the stream vocodes."""
    check_stream(taco1_systems, growth, max_iters, layout, name="taco1",
                 base=TACO1)


def test_stream_batch_matches_jax_and_one_shot(systems):
    """Three streams with speakers, padded to a batch of 4, stopping at
    different steps: JAX's rounds (an ended stream yields None), and the
    port's one-shot batch mel and vocode of its own mel batch."""
    extra = f",stop_threshold={stop_threshold(systems)}"
    jst, tst, tsyn, tvoc = make_streams(systems, extra)
    speakers = [0, 1, 2]
    jrounds = list(jst.stream_batch(TEXTS, speakers))
    trounds = list(tst.stream_batch(TEXTS, speakers))
    assert len(trounds) == len(jrounds)
    for jr, tr in zip(jrounds, trounds):
        for jc, tc in zip(jr, tr):
            assert (tc is None) == (jc is None)
            if tc is not None:
                np.testing.assert_allclose(tc, jc, atol=1e-6)
    totals = [m.shape[0] for m in tst.last_mels]
    assert len(set(totals)) > 1 and totals == [m.shape[0] for m in jst.last_mels]
    assert any(r[int(np.argmin(totals))] is None for r in trounds)
    np.testing.assert_allclose(tst.last_mel_batch, jst.last_mel_batch,
                               atol=1e-4)
    mels = one_shot_mels(tsyn, TEXTS, speakers)
    np.testing.assert_allclose(tst.last_mel_batch,
                               mels[:3, : max(totals)], atol=1e-6)
    wavs = tst.synthesize_batch(TEXTS, speakers)
    ref = tvoc.vocode_batch(tst.last_mel_batch, speakers, temperature=0.0)
    for i, w in enumerate(wavs):
        assert np.array_equal(w, ref[i, : totals[i] * tst._hop])


def test_sampled_stream_batch_equals_vocode_batch(systems):
    """At temperature 1 the stream's waveforms are vocode_batch's of its
    own mel batch exactly (same Philox noise at the same samples)."""
    _, tst, _, tvoc = make_streams(systems, temperature=1.0)
    wavs = tst.synthesize_batch(TEXTS[:2], [1, 2])
    ref = tvoc.vocode_batch(tst.last_mel_batch, [1, 2], temperature=1.0)
    for i, w in enumerate(wavs):
        assert np.array_equal(w, ref[i])


def test_stream_rejects_mixed_speakers(systems):
    _, tst, _, _ = make_streams(systems)
    with pytest.raises(ClientError):
        tst.synthesize_batch(["a", "b"], [0, -1])
