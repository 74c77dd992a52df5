"""The port's serving surface: the batchers, long-form synthesis and the
demo server.

The batcher and long-form tests mirror ``tests/test_batcher.py`` and
``tests/test_longform.py`` on the port's classes (stub synthesizers: no
model runs). The demo app is then held against the JAX package's
``demo_server.make_app`` over the same tiny weights, in-process:
``/synthesize`` (Griffin-Lim, JAX's phase on both sides) gives the same
length with int16 samples within 4, as ``tests/test_torch_cli.py`` holds
the synthesize CLI; ``/synthesize_batch`` the same zip member names and
lengths; ``/synthesize_stream`` at temperature 0 the same bytes
(identical codes, the same float32 mu-law decode); and every error route
the same status. Last, the port's threaded server answers on a local
port."""

import io
import json
import threading
import time
import urllib.error
import urllib.request
import zipfile
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import demo_server as jax_server
from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models import create_model as j_create
from nspeech_tpu.serving import Synthesizer as JSynth
from nspeech_tpu.serving import TextToSpeech as JTTS
from nspeech_tpu.serving import WaveNetVocoder as JVoc
from nspeech_tpu.serving.streaming import StreamingTTS as JStream
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.cli import demo_server as port_server
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models import WaveNet, create_model
from nspeech_tpu_torch.serving import batcher as batcher_mod
from nspeech_tpu_torch.serving import (DynamicBatcher, StreamBatcher,
                                       StreamingTTS, Synthesizer, TextToSpeech,
                                       WaveNetVocoder, split_text,
                                       synthesize_long)

torch.set_num_threads(1)


# -- the batchers, on stubs (mirrors tests/test_batcher.py) -------------------

class FakeSynth:
    """Deterministic per-text results and a batch-size log. A small sleep
    stands for device time, so concurrent requests pile into one window."""

    def __init__(self, delay=0.02, reject_mixed=False, bad_text=None):
        self.batch_sizes = []
        self.delay = delay
        self.reject_mixed = reject_mixed
        self.bad_text = bad_text
        self.lock = threading.Lock()

    def synthesize_batch(self, texts, speaker_ids=None):
        with self.lock:
            self.batch_sizes.append(len(texts))
        if self.reject_mixed and speaker_ids is not None:
            neg = [s for s in speaker_ids if s is None or s < 0]
            if neg and len(neg) != len(speaker_ids):
                raise ValueError("mixed default/explicit conditioning")
        if self.bad_text is not None and self.bad_text in texts:
            raise ValueError("bad text")
        time.sleep(self.delay)
        wavs = [np.full(4, float(len(t)), np.float32) for t in texts]
        mels = np.stack([np.full((3, 2), float(len(t))) for t in texts])
        return wavs, mels, mels


def fire(batcher, texts, speakers=None, stream=False):
    """One thread per request; returns ({i: result}, {i: exception})."""
    results, errors = {}, {}

    def one(i, t, s):
        try:
            results[i] = (list(batcher.stream(t, s, timeout=10)) if stream
                          else batcher.synthesize(t, s, timeout=10))
        except Exception as e:  # noqa: BLE001 - recorded for assertions
            errors[i] = e

    speakers = speakers or [-1] * len(texts)
    threads = [threading.Thread(target=one, args=(i, t, s))
               for i, (t, s) in enumerate(zip(texts, speakers))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive(), "a caller hung"
    return results, errors


def test_concurrent_requests_batch_and_fan_out():
    fake = FakeSynth()
    b = DynamicBatcher(fake, max_batch=8, window_ms=50)
    texts = ["a" * (i + 1) for i in range(10)]
    results, errors = fire(b, texts)
    b.close()
    assert not errors and len(results) == 10
    for i, t in enumerate(texts):
        wav, mel, _lin = results[i]
        assert wav[0] == len(t) and mel[0, 0] == len(t)   # each caller's own
    assert b.stats["requests"] == 10
    assert b.stats["batches"] < 10 and max(fake.batch_sizes) > 1
    assert b.stats["max_batch_seen"] == max(fake.batch_sizes)


def test_many_callers_under_frequent_thread_switches():
    """48 callers (more than the host's cores) with the interpreter
    switching threads every microsecond: each gets its own result, and
    the counters add up (one writer, the worker)."""
    import sys

    fake = FakeSynth(delay=0.001)
    b = DynamicBatcher(fake, max_batch=8, window_ms=5)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        texts = ["x" * (i + 1) for i in range(48)]
        results, errors = fire(b, texts)
    finally:
        sys.setswitchinterval(interval)
        b.close()
    assert not errors and sorted(results) == list(range(48))
    assert all(results[i][0][0] == i + 1 for i in range(48))
    assert b.stats["requests"] == 48 == sum(fake.batch_sizes)
    assert b.stats["batches"] == len(fake.batch_sizes)
    assert not b._worker.is_alive()


def test_mixed_speaker_conditioning_partitioned():
    fake = FakeSynth(reject_mixed=True)
    b = DynamicBatcher(fake, max_batch=8, window_ms=50)
    results, errors = fire(b, ["aa", "bbb", "cccc", "ddddd"], [-1, 2, -1, 3])
    b.close()
    assert not errors and len(results) == 4
    assert results[1][0][0] == 3 and results[3][0][0] == 5


def test_bad_request_fails_alone_and_is_counted_once():
    """A failed window re-runs each item alone: only the bad request
    fails, and the retries do not inflate the /stats counters."""
    fake = FakeSynth(bad_text="BAD")
    b = DynamicBatcher(fake, max_batch=8, window_ms=50)
    results, errors = fire(b, ["ok", "BAD", "fine"])
    b.close()
    assert set(errors) == {1} and isinstance(errors[1], ValueError)
    assert results[0][0][0] == 2 and results[2][0][0] == 4
    assert b.stats["requests"] == 3


def test_single_request_passthrough_and_batch_forward():
    fake = FakeSynth(delay=0.0)
    b = DynamicBatcher(fake, max_batch=4, window_ms=1)
    wav, _mel, _lin = b.synthesize("hello", -1)
    assert wav[0] == 5
    wavs, _m, _l = b.synthesize_batch(["xx", "yyy"])
    assert wavs[0][0] == 2 and wavs[1][0] == 3
    b.close()
    assert b.stats["requests"] == 1          # a caller's batch bypasses the window


def test_batchers_refuse_wrong_wrappees_and_dead_workers():
    with pytest.raises(ValueError, match="synthesize_batch"):
        DynamicBatcher(object())
    with pytest.raises(ValueError, match="stream_batch"):
        StreamBatcher(object())
    b = DynamicBatcher(FakeSynth(delay=0.0), max_batch=2, window_ms=1)
    b.close()
    with pytest.raises(RuntimeError, match="worker thread is dead"):
        b.synthesize("hello", -1)
    s = StreamBatcher(FakeStreamer(delay=0.0), window_ms=1)
    s.close()
    s._worker.join(timeout=5)
    with pytest.raises(RuntimeError, match="worker thread is dead"):
        next(s.stream("hello"))


class FakeStreamer:
    """stream_batch stub: stream i ends after len(text) % 3 + 1 chunks
    (None afterwards); chunk values are per text and round."""

    def __init__(self, delay=0.02, bad_text=None):
        self.batch_sizes = []
        self.delay = delay
        self.bad_text = bad_text
        self.lock = threading.Lock()

    def stream_batch(self, texts, speaker_ids=None):
        with self.lock:
            self.batch_sizes.append(len(texts))
        if self.bad_text is not None and self.bad_text in texts:
            raise ValueError("bad text")
        ends = [len(t) % 3 + 1 for t in texts]
        for rnd in range(max(ends)):
            time.sleep(self.delay)
            yield [np.full(4, float(len(t) * 10 + rnd), np.float32)
                   if rnd < ends[i] else None for i, t in enumerate(texts)]


def test_stream_batcher_groups_and_fans_out():
    fake = FakeStreamer()
    b = StreamBatcher(fake, max_batch=4, window_ms=100.0)
    texts = ["ab", "defg", "hijkl"]          # end after 3, 2, 1 chunks
    results, errors = fire(b, texts, stream=True)
    assert not errors and max(fake.batch_sizes) >= 2
    for i, t in enumerate(texts):
        assert len(results[i]) == len(t) % 3 + 1
        for rnd, c in enumerate(results[i]):
            np.testing.assert_array_equal(
                c, np.full(4, float(len(t) * 10 + rnd), np.float32))
    assert b.stats["requests"] == 3 and b.stats["batches"] <= 2
    assert b.stats["max_batch_seen"] == max(fake.batch_sizes)


def test_stream_batcher_partitions_and_aborts_groups():
    """Default and explicit speakers stream in separate groups; a failure
    mid-stream aborts its whole group (partial audio cannot be retried)."""
    fake = FakeStreamer()
    b = StreamBatcher(fake, max_batch=4, window_ms=100.0)
    results, errors = fire(b, ["ab", "cd", "ef"], [-1, 1, -1], stream=True)
    assert not errors and sorted(fake.batch_sizes) == [1, 2]
    fake = FakeStreamer(bad_text="bad")
    b = StreamBatcher(fake, max_batch=4, window_ms=100.0)
    results, errors = fire(b, ["ok text", "bad"], stream=True)
    assert set(errors) == {0, 1}
    assert all(isinstance(e, ValueError) for e in errors.values())


class GatedStreamer:
    """stream_batch stub whose groups hold the card until released: a
    group yields one chunk per stream (the text's length), blocks until
    its gate (keyed by its first text) opens, then yields a second (the
    length plus one) or, for a text starting with "bad", raises."""

    def __init__(self):
        self.gates = {}
        self.started = []               # each group's texts, in call order
        self.running = self.peak = 0
        self.lock = threading.Lock()

    def gate(self, text):
        with self.lock:
            return self.gates.setdefault(text, threading.Event())

    def stream_batch(self, texts, speaker_ids=None):
        gate = self.gate(texts[0])
        with self.lock:
            self.started.append(list(texts))
            self.running += 1
            self.peak = max(self.peak, self.running)
        try:
            yield [np.full(2, float(len(t)), np.float32) for t in texts]
            assert gate.wait(timeout=30), "the test never released the group"
            if any(t.startswith("bad") for t in texts):
                raise ValueError("bad text")
            yield [np.full(2, float(len(t) + 1), np.float32) for t in texts]
        finally:
            with self.lock:
                self.running -= 1


def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def start_stream(batcher, text, speaker_id=-1):
    """A caller on its own thread: (thread, {"chunks": [...]} or "error")."""
    out = {"chunks": []}

    def run():
        try:
            for c in batcher.stream(text, speaker_id, timeout=30):
                out["chunks"].append(c)
        except Exception as e:  # noqa: BLE001 - recorded for assertions
            out["error"] = e

    th = threading.Thread(target=run)
    th.start()
    return th, out


def finish(threads):
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive(), "a caller hung"


def test_stream_batcher_dispatches_while_a_group_streams():
    """A second group starts while the first still streams, and each
    caller gets its own group's chunks."""
    fake = GatedStreamer()
    b = StreamBatcher(fake, max_batch=4, window_ms=1)
    try:
        t1, first = start_stream(b, "first")
        wait_until(lambda: len(first["chunks"]) == 1)
        t2, second = start_stream(b, "second one")
        wait_until(lambda: len(second["chunks"]) == 1)
        assert fake.running == 2 and fake.started == [["first"], ["second one"]]
        assert len(first["chunks"]) == 1 and t1.is_alive()   # still streaming
        fake.gate("second one").set()
        finish([t2])
        fake.gate("first").set()
        finish([t1])
    finally:
        b.close()
    for out, n in ((first, 5.0), (second, 10.0)):
        assert "error" not in out
        np.testing.assert_array_equal(out["chunks"], [np.full(2, n), np.full(2, n + 1)])
    assert b.stats == {"requests": 2, "batches": 2, "max_batch_seen": 1}


def test_stream_batcher_failure_aborts_its_own_group_only():
    fake = GatedStreamer()
    b = StreamBatcher(fake, max_batch=4, window_ms=1)
    try:
        t1, good = start_stream(b, "good")
        wait_until(lambda: len(good["chunks"]) == 1)
        t2, bad = start_stream(b, "bad request")
        wait_until(lambda: len(bad["chunks"]) == 1)
        fake.gate("bad request").set()
        finish([t2])
        assert fake.running == 1 and not good.get("error")
        fake.gate("good").set()
        finish([t1])
    finally:
        b.close()
    assert isinstance(bad["error"], ValueError) and len(bad["chunks"]) == 1
    assert "error" not in good
    np.testing.assert_array_equal(good["chunks"], [np.full(2, 4.0), np.full(2, 5.0)])


def test_stream_batcher_close_with_groups_in_flight():
    """close() while two groups stream: both streams end whole, then the
    worker ends; a later request is refused."""
    fake = GatedStreamer()
    b = StreamBatcher(fake, max_batch=4, window_ms=1)
    callers = []
    for t in ("one", "three"):                 # a group each
        callers.append(start_stream(b, t))
        wait_until(lambda: len(callers[-1][1]["chunks"]) == 1)
    b.close()
    time.sleep(0.05)
    assert b._worker.is_alive() and fake.running == 2      # waits for them
    for t in ("one", "three"):
        fake.gate(t).set()
    finish([th for th, _ in callers])
    b._worker.join(timeout=10)
    assert not b._worker.is_alive() and fake.running == 0
    for (_, out), n in zip(callers, (3.0, 5.0)):
        assert "error" not in out
        np.testing.assert_array_equal(out["chunks"], [np.full(2, n), np.full(2, n + 1)])
    with pytest.raises(RuntimeError, match="worker thread is dead"):
        next(b.stream("late"))


def test_stream_batcher_batches_arrivals_while_its_slots_are_taken(monkeypatch):
    """With every group slot streaming, new arrivals queue; when a slot
    frees they start together as one group."""
    monkeypatch.setattr(batcher_mod, "GROUP_SLOTS", 1)
    fake = GatedStreamer()
    b = StreamBatcher(fake, max_batch=4, window_ms=1)
    try:
        t1, first = start_stream(b, "first")
        wait_until(lambda: len(first["chunks"]) == 1)
        later = [start_stream(b, t) for t in ("ab", "cde")]
        time.sleep(0.1)
        assert fake.started == [["first"]]                 # no free slot
        fake.gate("first").set()
        finish([t1])
        wait_until(lambda: len(fake.started) == 2)
        assert sorted(fake.started[1]) == ["ab", "cde"]     # one group
        fake.gate(fake.started[1][0]).set()
        finish([th for th, _ in later])
    finally:
        b.close()
    for (_, out), n in zip(later, (2.0, 3.0)):
        np.testing.assert_array_equal(out["chunks"], [np.full(2, n), np.full(2, n + 1)])
    assert b.stats == {"requests": 3, "batches": 2, "max_batch_seen": 2}


def test_stream_batcher_makes_its_group_slots_once():
    """Three slot threads, made with the batcher, stream every group; after
    close() they end with the worker."""
    fake = GatedStreamer()
    b = StreamBatcher(fake, max_batch=1, window_ms=1)
    slots = list(b._slot_threads)
    assert len(slots) == batcher_mod.GROUP_SLOTS == 3
    try:
        for round_ in range(2):
            callers = [start_stream(b, f"{round_} {t}") for t in ("a", "bb", "ccc")]
            wait_until(lambda: fake.running == 3)
            for g in fake.started[-3:]:
                fake.gate(g[0]).set()
            finish([th for th, _ in callers])
            wait_until(lambda: fake.running == 0)
    finally:
        b.close()
    b._worker.join(timeout=10)
    assert not b._worker.is_alive() and not any(th.is_alive() for th in slots)
    assert b._slot_threads == slots and b.stats["batches"] == 6


def test_stream_batcher_records_each_groups_seconds():
    fake = GatedStreamer()
    b = StreamBatcher(fake, max_batch=4, window_ms=1)
    try:
        th, out = start_stream(b, "one")
        wait_until(lambda: len(out["chunks"]) == 1)
        time.sleep(0.1)
        fake.gate("one").set()
        finish([th])
        wait_until(lambda: len(b._group_s) == 1)
    finally:
        b.close()
    assert 0.1 <= b._group_s[0] < 10


def test_stream_batcher_holds_the_last_free_slot(monkeypatch):
    """Two slots, one streaming, groups lately 0.4 s: a group that takes
    the last slot gathers until 0.2 s after its first arrival, so a
    request 0.05 s later joins it."""
    monkeypatch.setattr(batcher_mod, "GROUP_SLOTS", 2)
    fake = GatedStreamer()
    b = StreamBatcher(fake, max_batch=4, window_ms=1)
    b._group_s.append(0.4)
    try:
        t1, first = start_stream(b, "first")
        wait_until(lambda: len(first["chunks"]) == 1)
        t0 = time.monotonic()
        later = [start_stream(b, "ab")]
        time.sleep(0.05)
        later.append(start_stream(b, "cde"))
        wait_until(lambda: len(fake.started) == 2)
        assert time.monotonic() - t0 >= 0.19
        assert sorted(fake.started[1]) == ["ab", "cde"]
        for t in ("first", fake.started[1][0]):
            fake.gate(t).set()
        finish([t1] + [th for th, _ in later])
    finally:
        b.close()
    assert b.stats == {"requests": 3, "batches": 2, "max_batch_seen": 2}


HOLDS = {  # case: (slots, arrivals, the groups they start as)
    "another slot free": (3, ["ab", "cde"], [["ab"], ["cde"]]),
    "no group ended": (2, ["first", "ab"], [["first"], ["ab"]]),
    "max_batch": (2, ["first", "ab", "cde"], [["first"], ["ab", "cde"]]),
}


@pytest.mark.parametrize("case", list(HOLDS))
def test_stream_batcher_holds_nothing_else(monkeypatch, case):
    """No hold while another slot is free or before any group has ended
    (each arrival starts its own group at once), and a held group that
    reaches ``max_batch`` starts at once."""
    slots, texts, groups = HOLDS[case]
    monkeypatch.setattr(batcher_mod, "GROUP_SLOTS", slots)
    fake = GatedStreamer()
    b = StreamBatcher(fake, max_batch=2 if case == "max_batch" else 4, window_ms=1)
    if case != "no group ended":
        b._group_s.append(60.0)         # a hold of 20 s or 30 s
    callers = []
    try:
        for t in texts:
            callers.append(start_stream(b, t))
            if case != "max_batch" or t == "first":
                wait_until(lambda: len(callers[-1][1]["chunks"]) == 1, timeout=5)
        wait_until(lambda: sum(map(len, fake.started)) == len(texts), timeout=5)
        assert [sorted(g) for g in fake.started] == groups
        for g in list(fake.started):
            fake.gate(g[0]).set()
        finish([th for th, _ in callers])
    finally:
        b.close()
    assert all("error" not in out for _, out in callers)


def test_dynamic_batcher_runs_one_group_at_a_time():
    """Two groups of one window (default and explicit speakers) and a
    later request: DynamicBatcher's calls never overlap."""
    class Counting(FakeSynth):
        running = peak = 0

        def synthesize_batch(self, texts, speaker_ids=None):
            with self.lock:
                self.running += 1
                self.peak = max(self.peak, self.running)
            try:
                return super().synthesize_batch(texts, speaker_ids)
            finally:
                with self.lock:
                    self.running -= 1

    fake = Counting(delay=0.1, reject_mixed=True)
    b = DynamicBatcher(fake, max_batch=8, window_ms=20)
    late = threading.Timer(0.05, lambda: results.update(late=b.synthesize("late")))
    results = {}
    late.start()
    out, errors = fire(b, ["aa", "bbb", "cccc"], [-1, 2, -1])
    late.join(timeout=30)
    b.close()
    assert not errors and len(out) == 3 and results["late"][0][0] == 4
    assert fake.peak == 1 and b.stats["batches"] == len(fake.batch_sizes) >= 3


def test_server_warmup_touches_every_surface():
    """--warmup runs each surface a first request could hit: single
    (wav-only and full), the largest batch, a single stream and the
    largest stream batch."""
    calls = []

    class WarmSynth:
        def synthesize(self, text, speaker_id, want_features=True):
            calls.append(("synthesize", want_features))
            return np.zeros(4, np.float32), None, None

        def synthesize_batch(self, texts, speaker_ids=None):
            calls.append(("batch", len(texts)))
            return [np.zeros(4, np.float32)] * len(texts), None, None

    class WarmStreamer:
        def stream(self, text, speaker_id=-1):
            calls.append(("stream", 1))
            yield np.zeros(4, np.float32)

        def stream_batch(self, texts, speaker_ids=None):
            calls.append(("stream_batch", len(texts)))
            yield [np.zeros(4, np.float32)] * len(texts)

    port_server._warmup(WarmSynth(), StreamBatcher(WarmStreamer()),
                        SimpleNamespace(dynamic_batch=4))
    assert ("synthesize", False) in calls and ("synthesize", True) in calls
    assert ("batch", 4) in calls
    assert ("stream", 1) in calls and ("stream_batch", 4) in calls


# -- long-form (mirrors tests/test_longform.py) -------------------------------

def test_split_text_matches_jax():
    from nspeech_tpu.serving.longform import split_text as j_split

    text = "First sentence. Second one!  Third?\nFourth; and fifth."
    assert split_text(text) == j_split(text) == [
        "First sentence.", "Second one!", "Third?", "Fourth;", "and fifth."]
    clausey = ("alpha bravo charlie delta, echo foxtrot golf hotel, "
               "india juliett kilo lima")
    pieces = split_text(clausey, max_chars=30)
    assert pieces == j_split(clausey, max_chars=30)
    assert all(len(p) <= 30 for p in pieces)
    monster = "x" * 10 + " " + "y" * 12 + " " + "z" * 8
    assert split_text(monster, max_chars=15) == ["x" * 10, "y" * 12, "z" * 8]
    assert split_text("   ") == []


def test_synthesize_long_orders_and_paces_pieces():
    fake = FakeSynth(delay=0.0)
    wav = synthesize_long(fake, "Hi there. A much longer second sentence here!",
                          speaker_id=3, sample_rate=1000, pause_ms=100)
    assert len(wav) == 4 + 100 + 4
    assert wav[0] == len("Hi there.") and np.all(wav[4:104] == 0)
    assert wav[104] == len("A much longer second sentence here!")
    assert fake.batch_sizes == [2]          # one batch for all pieces


def test_synthesize_long_through_dynamic_batcher():
    fake = FakeSynth(delay=0.0)
    b = DynamicBatcher(fake, max_batch=4, window_ms=1)
    wav = synthesize_long(b, "One. Two. Three.", sample_rate=1000, pause_ms=50)
    b.close()
    assert len(wav) == 3 * 4 + 2 * 50
    with pytest.raises(ValueError, match="text"):
        synthesize_long(fake, "  ", sample_rate=1000)
    with pytest.raises(ValueError, match="sample_rate"):
        synthesize_long(fake, "Hello.")


# -- the demo app against JAX's, on the same tiny weights ---------------------

TACO = ("max_iters=4,outputs_per_step=2,encoder_conv_layers=1,"
        "postnet_conv_layers=1,expand_conv_layers=1,encoder_conv_channels=16,"
        "attention_dim=16,postnet_conv_channels=16,expand_conv_channels=16,"
        "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
        "embedding_dim=16,griffin_lim_iters=2")
VOC = ("dilations_length=3,dilations_depth=1,residual_channels=8,"
       "dilation_channels=8,skip_channels=16,quantization_channels=64,"
       "lc_channels=80,gc_channels=4,gc_category_cardinality=3")


@pytest.fixture(scope="module")
def apps():
    """(JAX app, port app) pairs: ``gl`` over the synthesizer alone with a
    temperature-0 streamer, ``tts`` over TextToSpeech."""
    jcfg, tcfg = j_load("taco2").parse(TACO), t_load("taco2").parse(TACO)
    jm = j_create("taco2", jcfg)
    jp, js = jm.init(jax.random.PRNGKey(0))
    jsyn = JSynth(jcfg, text_bucket=16).set_variables(jp, js, model=jm)
    tp, ts = convert.tacotron_variables(
        create_model("taco2", tcfg), jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js))
    tsyn = Synthesizer(tcfg, text_bucket=16, device="cpu").set_variables(
        tp, ts, model="taco2")
    jvcfg, tvcfg = j_load("wavenet").parse(VOC), t_load("wavenet").parse(VOC)
    jnet = j_create("wavenet", jvcfg)
    jvp = jnet.init(jax.random.PRNGKey(1))
    jvoc = JVoc(jvcfg, use_pallas=False).set_variables(jnet, jvp)
    tnet = WaveNet(tvcfg)
    tvoc = WaveNetVocoder(tvcfg, device="cpu").set_variables(
        tnet, convert.wavenet_params(tnet, jax.tree_util.tree_map(np.asarray, jvp)))
    kw = dict(chunk_frames=4, temperature=0.0, text_bucket=16)
    return {
        "gl": (jax_server.make_app(jsyn, jcfg, streamer=JStream(jsyn, jvoc, **kw)),
               port_server.make_app(tsyn, tcfg,
                                    streamer=StreamingTTS(tsyn, tvoc, **kw))),
        "tts": (jax_server.make_app(JTTS(jsyn, jvoc), jcfg),
                port_server.make_app(TextToSpeech(tsyn, tvoc), tcfg)),
    }


def call(app, path, query="", body=None):
    """(status code, headers, body bytes) of one in-process request."""
    got = {}

    def start_response(status, headers):
        got["status"], got["headers"] = int(status.split()[0]), dict(headers)

    environ = {"PATH_INFO": path, "QUERY_STRING": query}
    if body is not None:
        environ.update(CONTENT_LENGTH=str(len(body)),
                       **{"wsgi.input": io.BytesIO(body)})
    data = b"".join(app(environ, start_response))
    return got["status"], got["headers"], data


def test_synthesize_route_matches_jax(apps):
    j, t = apps["gl"]
    for query in ("text=Hello+there,+two+servers.", "text=short&speaker_id=-1"):
        (js_, jh, jb), (ts_, th, tb) = (call(j, "/synthesize", query),
                                        call(t, "/synthesize", query))
        assert js_ == ts_ == 200
        assert th["Content-Type"] == jh["Content-Type"] == "audio/wav"
        (sr_j, a), (sr_t, b) = wavfile.read(io.BytesIO(jb)), wavfile.read(io.BytesIO(tb))
        assert sr_j == sr_t and a.shape == b.shape and a.size > 0
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 4


def test_synthesize_batch_route_matches_jax(apps):
    j, t = apps["gl"]
    body = json.dumps({"texts": ["one", "and two", "three it is"]}).encode()
    (js_, _, jb), (ts_, th, tb) = (call(j, "/synthesize_batch", body=body),
                                   call(t, "/synthesize_batch", body=body))
    assert js_ == ts_ == 200 and th["Content-Type"] == "application/zip"
    jz, tz = zipfile.ZipFile(io.BytesIO(jb)), zipfile.ZipFile(io.BytesIO(tb))
    assert tz.namelist() == jz.namelist() == ["utt_000.wav", "utt_001.wav",
                                              "utt_002.wav"]
    for name in tz.namelist():
        a = wavfile.read(io.BytesIO(jz.read(name)))[1]
        b = wavfile.read(io.BytesIO(tz.read(name)))[1]
        assert a.shape == b.shape and a.size > 0


def test_synthesize_stream_route_matches_jax(apps):
    """Temperature 0: the same codes, so the same PCM bytes, after a WAV
    header with unknown sizes; no Content-Length (streamed)."""
    j, t = apps["gl"]
    (js_, jh, jb), (ts_, th, tb) = (call(j, "/synthesize_stream", "text=hello+world"),
                                    call(t, "/synthesize_stream", "text=hello+world"))
    assert js_ == ts_ == 200 and "Content-Length" not in th
    assert tb[:4] == b"RIFF" and tb[4:8] == b"\xff\xff\xff\xff"
    assert len(tb) > 44 and tb == jb


@pytest.mark.parametrize("app,path,query,body", [
    ("gl", "/", "", None),
    ("gl", "/nowhere", "", None),
    ("gl", "/synthesize", "", None),
    ("gl", "/synthesize", "text=hi&speaker_id=abc", None),
    ("gl", "/synthesize_stream", "", None),
    ("gl", "/synthesize_stream", "text=hi&speaker_id=abc", None),
    ("tts", "/synthesize_stream", "text=hi", None),          # no streamer
    ("gl", "/synthesize_batch", "", b"not json"),
    ("gl", "/synthesize_batch", "", b'{"texts": []}'),
    ("gl", "/synthesize_batch", "", b'{"texts": ["a"], "speaker_ids": [true]}'),
    ("tts", "/synthesize_batch", "", b'{"texts": ["a", "b"], "speaker_ids": [0, -1]}'),
    ("gl", "/stats", "", None)])
def test_routes_answer_with_jax_status(apps, app, path, query, body):
    j, t = apps[app]
    (js_, _, jb), (ts_, _, tb) = call(j, path, query, body), call(t, path, query, body)
    assert ts_ == js_
    if js_ != 200 or path == "/":
        assert tb == jb                     # same page, same error text


def test_stats_route_through_the_batcher():
    """/synthesize works unchanged through the batcher; unknown paths
    share one counter; /stats carries the batcher's counts."""
    b = DynamicBatcher(FakeSynth(delay=0.0), max_batch=4, window_ms=1)
    app = port_server.make_app(b, SimpleNamespace(sample_rate=16000))
    status, _, body = call(app, "/synthesize", "text=hello")
    assert status == 200 and body[:4] == b"RIFF"
    for junk in ("/admin.php", "/wp-login", "/.env"):
        call(app, junk)
    stats = json.loads(call(app, "/stats")[2])
    b.close()
    assert stats["routes"]["/synthesize"] == 1 and stats["routes"]["other"] == 3
    assert stats["dynamic_batching"]["requests"] == 1


def test_threaded_server_serves_on_a_local_port():
    """make_server binds port 0 on 127.0.0.1; concurrent GETs all answer."""
    b = DynamicBatcher(FakeSynth(delay=0.05), max_batch=8, window_ms=50)
    server = port_server.make_server(
        port_server.make_app(b, SimpleNamespace(sample_rate=16000)), 0,
        host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_port
    out = {}

    def get(i):
        with urllib.request.urlopen(f"{base}/synthesize?text={'a' * (i + 1)}",
                                    timeout=30) as r:
            out[i] = (r.status, r.read())

    try:
        threads = [threading.Thread(target=get, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive(), "a request hung"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/synthesize?text=a&speaker_id=abc",
                                   timeout=30)
        assert e.value.code == 400
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        b.close()
    assert sorted(out) == [0, 1, 2, 3]
    assert all(s == 200 and body[:4] == b"RIFF" for s, body in out.values())
    assert stats["dynamic_batching"]["max_batch_seen"] >= 2
