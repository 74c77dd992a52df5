"""``StreamingTTS`` under concurrent callers, on the CPU at tiny widths.

- Two threads' ``stream_batch`` calls, run at once, give the chunks of the
  same calls run one after the other, bit for bit, and each thread reads
  its own call's ``last_mels`` and ``last_launch_to_delivery``; a thread
  that ran no call reads the latest call's.
- Admission: with the room patched to N rows, a call that does not
  fit waits until a call ends, waiters enter in arrival order (a later
  call that would fit waits behind an earlier one that does not), and a
  call larger than the whole room streams alone.
- A closed generator, and one that raised, give their rows back.
- The sampler runs a call's streams alone, not the Tacotron half's
  padding rows, and gives the one-shot vocode of the call's mel batch.
- Inside a profile each call records ``stream.admit`` with its ``rows``
  (its streams: the sampler runs no padding rows) and the rows
  ``inflight`` at admission, before its ``stream.prefix``.

This file imports no JAX.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.models import WaveNet, create_model
from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
from nspeech_tpu_torch.serving import StreamingTTS, Synthesizer, WaveNetVocoder
from nspeech_tpu_torch.utils import profiling

torch.set_num_threads(1)

TACO = ("max_iters=6,outputs_per_step=2,encoder_conv_layers=1,"
        "postnet_conv_layers=2,postnet_conv_width=3,expand_conv_layers=1,"
        "encoder_conv_channels=16,attention_dim=16,postnet_conv_channels=16,"
        "expand_conv_channels=16,decoder_lstm_units=16,encoder_lstm_units=8,"
        "expand_lstm_units=8,embedding_dim=16")
AUDIO = ",num_mels=8,num_freq=65,sample_rate=4000"     # a hop of 50 samples
VOC = ("dilations_length=3,dilations_depth=1,residual_channels=8,"
       "dilation_channels=8,skip_channels=16,quantization_channels=64,"
       "lc_channels=8")
CALLS = (["hello world", "a very different input line"], ["hi there"])


def make_streamer(with_vocoder=False):
    cfg = load_config("taco2").parse(TACO + AUDIO)
    vcfg = load_config("wavenet").parse(VOC + AUDIO)
    params, bn = create_model("taco2", cfg).init(0)
    net = WaveNet(vcfg)
    syn = Synthesizer(cfg, text_bucket=16, device="cpu").set_variables(
        params, bn, model="taco2")
    voc = WaveNetVocoder(vcfg, device="cpu").set_variables(net, net.init(1))
    st = StreamingTTS(syn, voc, chunk_frames=4, temperature=1.0,
                      text_bucket=16, growth=1)
    return (st, voc) if with_vocoder else st


@pytest.fixture
def streamer():
    return make_streamer()


def wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def run_threads(targets):
    threads = [threading.Thread(target=t) for t in targets]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads), "a caller hung"


def test_concurrent_calls_equal_sequential_with_their_own_results(streamer):
    want = []
    for texts in CALLS:
        chunks = [[c.copy() if c is not None else None for c in r]
                  for r in streamer.stream_batch(texts)]
        want.append((chunks, [m.copy() for m in streamer.last_mels],
                     len(streamer.last_launch_to_delivery)))
    assert all(len(w[0]) > 2 for w in want)               # several launches

    both_started, first_done = threading.Barrier(2, timeout=60), threading.Event()
    got = {}

    def call(i):
        rounds = []
        for k, r in enumerate(streamer.stream_batch(CALLS[i])):
            rounds.append(r)
            if k == 0:
                both_started.wait()      # both calls are mid-stream
                if i == 1:
                    assert first_done.wait(timeout=60)   # call 1 ends last
        got[i] = (rounds, list(streamer.last_mels),
                  len(streamer.last_launch_to_delivery))
        if i == 0:
            first_done.set()

    run_threads([lambda: call(0), lambda: call(1)])
    for i, (chunks, mels, n) in enumerate(want):
        rounds, got_mels, got_n = got[i]
        assert len(rounds) == len(chunks) and got_n == n == len(chunks)
        for a, b in zip(rounds, chunks):
            assert [x is None for x in a] == [x is None for x in b]
            assert all(x is None or np.array_equal(x, y) for x, y in zip(a, b))
        assert len(got_mels) == len(mels)
        assert all(np.array_equal(x, y) for x, y in zip(got_mels, mels))
    # this thread ran no call: it reads the latest one's (call 1's)
    assert len(streamer.last_mels) == 1
    assert np.array_equal(streamer.last_mel, want[1][1][0])
    assert streamer._admission.inflight == 0


def test_calls_wait_for_room_in_arrival_order(streamer, monkeypatch):
    """Room 3: call A (2 rows) streams; B (2 rows) does not fit and waits;
    C (1 row) would fit but arrived after B, so it waits too. When A ends
    B enters, then C beside it."""
    monkeypatch.setattr(streamer, "_room", lambda gen: 3)
    gate = streamer._admission
    order = []
    enter = gate.enter

    def recorded(rows, room):
        before = enter(rows, room)
        order.append((rows, before))
        return before

    monkeypatch.setattr(gate, "enter", recorded)
    a = streamer.stream_batch(["first call", "second row"])
    next(a)
    assert gate.inflight == 2
    run = {}
    b = threading.Thread(target=lambda: run.update(b=list(streamer.stream_batch(
        ["waits for room", "two rows"]))))
    b.start()
    wait_until(lambda: len(gate._queue) == 1)
    c = threading.Thread(target=lambda: run.update(c=list(streamer.stream_batch(
        ["one row"]))))
    c.start()
    wait_until(lambda: len(gate._queue) == 2)
    time.sleep(0.05)
    assert order == [(2, 0)] and gate.inflight == 2      # both still wait
    for _ in a:                                          # A ends
        pass
    b.join(timeout=120)
    c.join(timeout=120)
    assert not b.is_alive() and not c.is_alive()
    assert order == [(2, 0), (2, 0), (1, 2)]
    assert run["b"] and run["c"] and gate.inflight == 0


def test_a_call_larger_than_the_room_streams_alone(streamer, monkeypatch):
    monkeypatch.setattr(streamer, "_room", lambda gen: 1)
    wavs = streamer.synthesize_batch(["two rows", "in one call"])
    assert all(len(w) for w in wavs) and streamer._admission.inflight == 0


def test_closed_or_failed_generator_gives_its_rows_back(streamer, monkeypatch):
    gate = streamer._admission
    g = streamer.stream_batch(["three", "rows, the", "sampler's"])
    next(g)
    assert gate.inflight == 3
    g.close()
    assert gate.inflight == 0
    calls = []
    orig = CudaWaveNetGenerator.generate_chunk

    def fails_second(self, *a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("launch failed")
        return orig(self, *a, **k)

    monkeypatch.setattr(CudaWaveNetGenerator, "generate_chunk", fails_second)
    with pytest.raises(RuntimeError, match="launch failed"):
        list(streamer.stream_batch(["a longer utterance to stream"]))
    assert gate.inflight == 0


def test_admit_span_records_rows_and_inflight(streamer):
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        first = streamer.stream_batch(["streams first"])
        next(first)
        for _ in streamer.stream_batch(["then three", "more", "rows"]):
            pass
        for _ in first:
            pass
    recs = profiling.spans()
    profiling.clear()
    admits = [r for r in recs if r.name == "stream.admit"]
    prefixes = [r for r in recs if r.name == "stream.prefix"]
    assert [r.attrs for r in admits] == [{"rows": 1, "inflight": 0},
                                         {"rows": 3, "inflight": 1}]
    assert len(prefixes) == 2
    assert all(a.t0_ns <= a.t1_ns <= p.t0_ns
               for a, p in zip(admits, sorted(prefixes, key=lambda r: r.t0_ns)))


def test_the_sampler_runs_the_real_streams_alone(monkeypatch):
    """Three texts: the decoder's batch is padded to 4, the sampler's
    carry and conditioning hold 3 rows, and the waveforms are the one-shot
    vocode of the call's own mel batch, bit for bit."""
    streamer, voc = make_streamer(with_vocoder=True)
    rows = []
    orig = CudaWaveNetGenerator.generate_chunk

    def spy(self, carry, n_samples, seed=0, lc=None, **k):
        rows.append((carry[1].shape[0], lc.shape[0]))
        return orig(self, carry, n_samples, seed=seed, lc=lc, **k)

    monkeypatch.setattr(CudaWaveNetGenerator, "generate_chunk", spy)
    texts = ["three streams", "in one", "call of the batcher"]
    wavs = streamer.synthesize_batch(texts)
    assert rows and set(rows) == {(3, 3)}
    ref = voc.vocode_batch(streamer.last_mel_batch, temperature=1.0)
    for i, w in enumerate(wavs):
        assert np.array_equal(w, ref[i, : len(w)])
        assert len(w) == streamer.last_mels[i].shape[0] * streamer._hop
