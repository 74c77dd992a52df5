"""The port's span recorder (``utils/profiling.py`` ``span``, ``record``,
``spans``) and the spans at its layer boundaries, on the CPU unless
marked ``gpu``.

- Outside a ``torch.profiler`` profile nothing is recorded and a span is
  one shared object; inside one, spans nest per thread, carry their
  attributes, appear in the profile as ``nspeech:`` events, and the
  buffer drops its oldest records and counts them.
- Inside a profile: a tiny ``StreamBatcher`` over ``StreamingTTS``
  records ``batcher.group`` with its rows and one ``batcher.wait`` per
  request under it, and ``stream.prefix`` and ``stream.launch`` (with
  the launch's index) under the group; ``DynamicBatcher`` records its
  waits and groups; one Tacotron-2 train step records its five ``train.*`` phases
  once each, in order, under the caller's span; the feeder records
  ``feeder.take`` and ``feeder.make``. A WaveNet step records its four
  phases and ``WaveNetFeeder`` ``feeder.featurize`` and ``feeder.make``,
  once each per step on a corpus of two windows an utterance, none
  outside a profile, and the step's result is the same with or without
  them, bit for bit.
- Each ``program_span`` metric of ``benchmark/metrics/`` that reads the
  spans returns the value the spans give, and None without spans (as on
  a program that records no ``stream.admit``), after the buffer dropped
  records, or on a program without the recorder.
- The cost of a span outside a profile.
- ``gpu``: a span's ``t0_ns`` and its ``nspeech:`` event in the same
  profile agree within 100 us; a kernel launched inside a span starts on
  the card after the span's ``t0_ns``; the benchmark's ``Tracer`` counts
  the same kernel launches with and without spans over a Tacotron step
  that captures its CUDA graph and a WaveNet step that replays one, and
  those steps record ``train.replay`` and, for the capture, its phases.

This file imports no JAX, so the ``gpu`` tests run where only PyTorch is
installed:

    python -m pytest tests/test_torch_tracing.py -m gpu -q --noconftest
"""

import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import core
from benchmark.harness.core import Run
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.data.feeder import DataFeeder
from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder
from nspeech_tpu_torch.models import WaveNet, create_model
from nspeech_tpu_torch.serving import (DynamicBatcher, StreamBatcher,
                                       StreamingTTS, Synthesizer,
                                       WaveNetVocoder)
from nspeech_tpu_torch.train.loop import (TrainState, batch_to_device,
                                          build_tacotron_train_step,
                                          build_wavenet_train_step, create_state,
                                          wavenet_batch_to_device)
from nspeech_tpu_torch.train.optim import make_optimizer
from nspeech_tpu_torch.utils import profiling
from nspeech_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

TACO = ("max_iters=6,outputs_per_step=2,encoder_conv_layers=1,"
        "postnet_conv_layers=2,postnet_conv_width=3,expand_conv_layers=1,"
        "encoder_conv_channels=16,attention_dim=16,postnet_conv_channels=16,"
        "expand_conv_channels=16,decoder_lstm_units=16,encoder_lstm_units=8,"
        "expand_lstm_units=8,embedding_dim=16")
VOC = ("dilations_length=3,dilations_depth=1,residual_channels=8,"
       "dilation_channels=8,skip_channels=16,quantization_channels=64,"
       "lc_channels=80")
TEXTS = ["hello world", "a very different input line", "hi"]


def _profile(cuda=False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


@pytest.fixture(autouse=True)
def _fresh():
    profiling.clear()
    yield
    profiling.clear()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


# -- the recorder ---------------------------------------------------------------

def test_outside_a_profile_nothing_is_recorded():
    assert profiling.span("a", x=1) is profiling.span("b")
    with profiling.span("a", x=1):
        pass
    assert profiling.stamp() is None
    profiling.record("c", 1, 2)
    profiling.record("c", profiling.stamp(), time.time_ns())
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_spans_nest_carry_attrs_and_appear_in_the_profile():
    with _profile() as prof:
        with profiling.span("outer", rows=3):
            t = profiling.stamp()
            with profiling.span("inner"):
                torch.ones(4) + 1
            profiling.record("late", t, time.time_ns(), index=7)
    recs = _by_name(profiling.spans())
    outer, inner, late = recs["outer"][0], recs["inner"][0], recs["late"][0]
    assert outer.parent is None and outer.attrs == {"rows": 3}
    assert inner.parent == outer.id and late.parent == outer.id
    assert inner.attrs == {} and late.attrs == {"index": 7} and late.t0_ns == t
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    assert len({outer.id, inner.id, late.id}) == 3
    assert outer.thread == threading.current_thread().name
    assert [r.name for r in profiling.spans("inner")] == ["inner"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"nspeech:outer", "nspeech:inner"} <= names
    assert "nspeech:late" not in names        # a record() span has no event


def test_each_thread_has_its_own_stack():
    def worker():
        with profiling.span("w"):
            with profiling.span("w.child"):
                pass

    with _profile():
        with profiling.span("main"):
            th = threading.Thread(target=worker, name="tracing-worker")
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    recs = _by_name(profiling.spans())
    w, child, main = recs["w"][0], recs["w.child"][0], recs["main"][0]
    assert w.parent is None and child.parent == w.id and main.parent is None
    assert w.thread == "tracing-worker" and main.thread != w.thread


def test_a_span_open_when_the_profile_ends_is_not_kept():
    with _profile():
        sp = profiling.span("straddles")
        sp.__enter__()
    sp.__exit__(None, None, None)
    assert profiling.spans() == []
    with profiling.span("after"):
        pass
    assert profiling.spans() == []


def test_the_buffer_drops_the_oldest_and_counts(monkeypatch):
    import collections

    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=3))
    with _profile():
        for i in range(5):
            with profiling.span("s", i=i):
                pass
    assert [r.attrs["i"] for r in profiling.spans()] == [2, 3, 4]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_a_span_outside_a_profile_costs_little():
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("train.update"):
            pass
    off_ns = (time.perf_counter() - t0) / n * 1e9
    t0 = time.perf_counter()
    for _ in range(n):
        pass
    loop_ns = (time.perf_counter() - t0) / n * 1e9
    print(f"span() outside a profile: {off_ns - loop_ns:.0f} ns "
          f"({off_ns:.0f} with the loop)")
    assert off_ns - loop_ns < 5000


# -- the layers' spans ----------------------------------------------------------

@pytest.fixture(scope="module")
def streamer():
    cfg, vcfg = load_config("taco2").parse(TACO), load_config("wavenet").parse(VOC)
    params, bn = create_model("taco2", cfg).init(0)
    net = WaveNet(vcfg)
    syn = Synthesizer(cfg, text_bucket=16, device="cpu").set_variables(
        params, bn, model="taco2")
    voc = WaveNetVocoder(vcfg, device="cpu").set_variables(net, net.init(1))
    return StreamingTTS(syn, voc, chunk_frames=4, temperature=0.0,
                        text_bucket=16)


def _fire(fn, texts):
    """One thread per request; returns {i: result}."""
    out, threads = {}, []
    for i, t in enumerate(texts):
        th = threading.Thread(target=lambda i=i, t=t: out.__setitem__(i, fn(t)))
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    return out


def test_stream_batcher_records_waits_prefix_and_launches(streamer):
    batcher = StreamBatcher(streamer, max_batch=4, window_ms=500)
    try:
        with _profile():
            wavs = _fire(lambda t: np.concatenate(list(batcher.stream(t))), TEXTS)
            batcher.close()                 # the group's span closes first
            batcher._worker.join(timeout=30)
    finally:
        batcher.close()
    assert not batcher._worker.is_alive()
    recs = _by_name(profiling.spans())
    (group,) = recs["batcher.group"]
    assert group.attrs == {"rows": len(TEXTS), "queued": 0}
    waits = recs["batcher.wait"]
    assert len(waits) == len(TEXTS)
    assert all(w.parent == group.id and w.attrs == {} for w in waits)
    assert all(w.t1_ns <= group.t0_ns and w.seconds >= 0 for w in waits)
    (prefix,) = recs["stream.prefix"]
    launches = recs["stream.launch"]
    assert prefix.parent == group.id and all(r.parent == group.id for r in launches)
    assert prefix.attrs == {}
    assert [r.attrs for r in launches] == [{"index": i} for i in range(len(launches))]
    assert len(wavs) == len(TEXTS) and all(len(w) > 0 for w in wavs.values())
    assert prefix.t1_ns <= launches[0].t1_ns <= group.t1_ns
    assert len(streamer.last_launch_to_delivery) == len(launches)


def test_dynamic_batcher_records_waits_and_groups():
    class Stub:
        def synthesize_batch(self, texts, speaker_ids=None):
            time.sleep(0.02)
            return [np.zeros(2)] * len(texts), [None] * len(texts), [None] * len(texts)

    batcher = DynamicBatcher(Stub(), max_batch=8, window_ms=300)
    try:
        with _profile():
            _fire(batcher.synthesize, ["a", "b", "c", "d"])
            batcher.synthesize("e")
            batcher.close()                 # the last group's span closes first
    finally:
        batcher.close()
    assert not batcher._worker.is_alive()
    recs = _by_name(profiling.spans())
    groups = sorted(recs["batcher.group"], key=lambda r: r.t0_ns)
    assert [g.attrs for g in groups] == [{"rows": 4, "queued": 0},
                                         {"rows": 1, "queued": 0}]
    waits = recs["batcher.wait"]
    assert len(waits) == 5
    for g in groups:
        mine = [w for w in waits if w.parent == g.id]
        assert len(mine) == g.attrs["rows"]
        assert all(w.t1_ns <= g.t0_ns for w in mine)


TRAIN = ("encoder_conv_layers=1,postnet_conv_layers=1,expand_conv_layers=1,"
         "encoder_conv_channels=16,attention_dim=16,postnet_conv_channels=16,"
         "expand_conv_channels=16,decoder_lstm_units=16,encoder_lstm_units=8,"
         "expand_lstm_units=8,embedding_dim=16,outputs_per_step=2,"
         "batch_size=2,batch_group_size=1,ema_decay=0.5")


def _train_setup(device="cpu"):
    cfg = load_config("taco2").parse(TRAIN)
    model = create_model("taco2", cfg)
    optimizer, schedule = make_optimizer(cfg, "taco2")
    step_fn = build_tacotron_train_step(model, optimizer, schedule=schedule,
                                        ema_decay=float(cfg.ema_decay))
    params, bn = model.init(0)
    params = tree_map(lambda t: t.to(device), params)
    bn = tree_map(lambda t: t.to(device), bn)
    state = TrainState(0, params, bn, optimizer.init(params),
                       tree_map(torch.clone, params))
    rng = np.random.default_rng(0)
    t_in, t_out = 12, 20
    batch = SimpleNamespace(
        inputs=rng.integers(1, 30, (2, t_in)).astype(np.int32),
        input_lengths=np.array([t_in, t_in - 3], np.int32),
        speaker_ids=np.zeros(2, np.int32),
        mel_targets=rng.standard_normal((2, t_out, cfg.num_mels)).astype(np.float32),
        linear_targets=rng.standard_normal((2, t_out, cfg.num_freq)).astype(np.float32))
    return step_fn, state, batch


def test_train_step_records_its_five_phases():
    step_fn, state, batch = _train_setup()
    with _profile():
        with profiling.span("test.step") as outer:
            data = batch_to_device(batch, torch.device("cpu"))
            state, metrics = step_fn(state, data, None)
    recs = _by_name(profiling.spans())
    phases = ["train.to_device", "train.forward", "train.backward",
              "train.merge", "train.update"]
    got = [recs[p] for p in phases]
    assert all(len(g) == 1 for g in got)
    got = [g[0] for g in got]
    assert all(r.parent == outer.id for r in got)
    assert [r.name for r in sorted(got, key=lambda r: r.t0_ns)] == phases
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(got, got[1:]))
    assert all(r.attrs == {} for r in got)
    assert torch.isfinite(metrics["loss"])


def test_feeder_records_take_and_make(tmp_path):
    from tests.make_synth_corpus import make_corpus

    corpus = make_corpus(str(tmp_path / "corpus"), n=4)
    cfg = load_config("taco2").parse("batch_size=2,batch_group_size=2")
    feeder = DataFeeder({"ljspeech": corpus}, cfg, seed=0, prefetch=1)
    stream = feeder.batches()
    next(stream)                                     # the corpus featurized
    with _profile():
        for _ in range(3):
            next(stream)
    stream.close()
    recs = _by_name(profiling.spans())
    takes = recs["feeder.take"]
    assert len(takes) == 3
    assert all(r.thread == threading.current_thread().name for r in takes)
    makes = recs["feeder.make"]
    assert makes and all(r.thread != takes[0].thread for r in makes)


def _wavenet_setup(tmp_path, device="cpu"):
    """A vocoder step, its state on ``device`` and its feeder's stream over
    clips of 6,000 samples, trimmed to 5,632: two windows of 9 + 2,000
    samples each, one batch."""
    from scipy.io import wavfile

    (tmp_path / "wavs").mkdir()
    t = np.arange(6000) / 20000.0
    lines = []
    for i in range(4):
        wav = 0.6 * np.sin(2 * np.pi * (200 + 50 * i) * t)
        wavfile.write(str(tmp_path / "wavs" / f"W{i}.wav"), 20000,
                      (wav * 32767).astype(np.int16))
        lines.append(f"W{i}|text {i}|text {i}")
    (tmp_path / "metadata.csv").write_text("\n".join(lines) + "\n")
    cfg = load_config("wavenet").parse(VOC + ",sample_size=2000,batch_size=2")
    net = create_model("wavenet", cfg)
    optimizer, schedule = make_optimizer(cfg, "wavenet")
    step_fn = build_wavenet_train_step(net, optimizer, cfg, schedule=schedule,
                                       use_lc=True)
    feeder = WaveNetFeeder({"ljspeech": str(tmp_path)}, net.receptive_field, cfg)
    return step_fn, create_state(net, optimizer, 0, device=device), feeder.batches()


def test_wavenet_step_and_feeder_record_their_phases(tmp_path):
    step_fn, state, stream = _wavenet_setup(tmp_path)
    cpu = torch.device("cpu")
    state, _ = step_fn(state, wavenet_batch_to_device(next(stream), cpu))
    assert profiling.spans() == []                  # outside a profile
    outers = []
    with _profile():
        for _ in range(2):
            with profiling.span("test.step") as outer:
                batch = next(stream)
                state, metrics = step_fn(state, wavenet_batch_to_device(batch, cpu))
            outers.append(outer.id)
    stream.close()
    phases = ["feeder.featurize", "feeder.make", "train.to_device",
              "train.forward", "train.backward", "train.update"]
    for outer in outers:
        mine = sorted((r for r in profiling.spans() if r.parent == outer),
                      key=lambda r: r.t0_ns)
        assert [r.name for r in mine] == phases
        assert all(a.t1_ns <= b.t0_ns for a, b in zip(mine, mine[1:]))
        assert mine[0].attrs == {"samples": 9 + 5632}
        assert mine[1].attrs == {"utterances": 1}
        assert all(r.attrs == {} for r in mine[2:])
    assert torch.isfinite(metrics["loss"])


def test_wavenet_step_is_the_same_with_spans(tmp_path):
    step_fn, state, stream = _wavenet_setup(tmp_path)
    data = wavenet_batch_to_device(next(stream), torch.device("cpu"))
    stream.close()
    plain, m_plain = step_fn(state, data)
    with _profile():
        traced, m_traced = step_fn(state, data)
    assert len(profiling.spans()) == 3
    assert torch.equal(m_plain["loss"], m_traced["loss"])
    for a, b in zip(tree_leaves(plain.params) + tree_leaves(plain.opt_state),
                    tree_leaves(traced.params) + tree_leaves(traced.opt_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# -- the metrics that read the spans --------------------------------------------

def _recorded(spec):
    """Record spans (name, t0 s, t1 s, attrs) inside a profile, as the
    program's layers would; a ("group", attrs, spec) item records its
    spec under a batcher.group span."""
    def run(items):
        for item in items:
            if item[0] == "group":
                with profiling.span("batcher.group", **item[1]):
                    run(item[2])
            else:
                name, t0, t1, attrs = item
                profiling.record(name, int(t0 * 1e9), int(t1 * 1e9), **attrs)

    with _profile():
        run(spec)


BASE = 1_000_000.0      # seconds: a time.time_ns()-sized origin
STREAM_SPANS = [
    ("group", {"rows": 3, "queued": 0},
     [("batcher.wait", BASE, BASE + w, {}) for w in (1.0, 2.0, 3.0)]
     + [("stream.prefix", BASE + 10, BASE + 10.1, {}),
        ("stream.launch", BASE + 10.1, BASE + 10.7, {"index": 0}),
        ("stream.launch", BASE + 10.7, BASE + 11.0, {"index": 1})]),
    ("group", {"rows": 2, "queued": 1},
     [("batcher.wait", BASE, BASE + w, {}) for w in (4.0, 5.0)]
     + [("stream.prefix", BASE + 20, BASE + 20.3, {}),
        ("stream.launch", BASE + 20.3, BASE + 20.8, {"index": 0})]),
    # its requests were queued before the profile began: no waits
    ("group", {"rows": 4, "queued": 2},
     [("stream.prefix", BASE + 30, BASE + 30.2, {}),
      ("stream.launch", BASE + 30.2, BASE + 31.2, {"index": 0})])]
# four calls' admissions: two while others streamed, waits 0, 0.1, 0.5, 0
ADMIT_SPANS = [
    ("group", {"rows": 1, "queued": 0},
     [("stream.admit", BASE + t, BASE + t + w, {"rows": rows, "inflight": busy})])
    for t, w, rows, busy in ((0, 0.0, 1, 0), (1, 0.1, 2, 1), (2, 0.5, 4, 3),
                             (9, 0.0, 1, 0))]
TRAIN_SPANS = [(n, BASE + k, BASE + k + d, {}) for k, (n, d) in enumerate(
    [("train.to_device", 0.010), ("train.forward", 0.200), ("train.backward", 0.300),
     ("train.merge", 0.040), ("train.update", 0.090), ("feeder.take", 0.003),
     ("train.forward", 0.100), ("feeder.make", 0.020), ("feeder.make", 0.010),
     ("feeder.featurize", 0.040)])]

METRICS = {
    "batcher_wait_p90_s.stream": (STREAM_SPANS, 4.6),
    "prefix_s_p50.stream": (STREAM_SPANS, 0.2),
    "group_first_chunk_s_p50.stream": (STREAM_SPANS, 0.8),
    "group_rows_mean.stream": (STREAM_SPANS, 3.0),
    "queued_at_dispatch_mean.stream": (STREAM_SPANS, 1.0),
    "overlap_share.stream": (ADMIT_SPANS, 50.0),
    "admit_wait_p90_s.stream": (ADMIT_SPANS, 0.1 + 0.7 * 0.4),
    "to_device_ms_per_step.train": (TRAIN_SPANS, 10.0 / 2),
    "forward_ms_per_step.train": (TRAIN_SPANS, 300.0 / 2),
    "backward_ms_per_step.train": (TRAIN_SPANS, 300.0 / 2),
    "merge_ms_per_step.train": (TRAIN_SPANS, 40.0 / 2),
    "update_ms_per_step.train": (TRAIN_SPANS, 90.0 / 2),
    "feeder_take_ms_per_step.train": (TRAIN_SPANS, 3.0 / 2),
    "feeder_busy_ms_per_step.train": (TRAIN_SPANS, 30.0 / 2),
    "to_device_ms_per_step.wavenet_train": (TRAIN_SPANS, 10.0 / 2),
    "forward_ms_per_step.wavenet_train": (TRAIN_SPANS, 300.0 / 2),
    "backward_ms_per_step.wavenet_train": (TRAIN_SPANS, 300.0 / 2),
    "update_ms_per_step.wavenet_train": (TRAIN_SPANS, 90.0 / 2),
    "feeder_make_ms_per_step.wavenet_train": (TRAIN_SPANS, (30.0 + 40.0) / 2),
}


def _run():
    return Run(window_s=10.0, records=[], counters={}, info={"traced": {"steps": 2}})


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metric_reads_the_spans(metric, monkeypatch):
    spec, want = METRICS[metric]
    read = core.module("metrics", metric).read
    assert read(_run(), None) is None                  # no spans
    _recorded(spec)
    assert read(_run(), None) == pytest.approx(want, rel=1e-6)
    monkeypatch.setattr(profiling, "_dropped", 1)      # a part of the window
    assert read(_run(), None) is None
    monkeypatch.delattr(profiling, "spans")            # a program without them
    assert read(_run(), None) is None


@pytest.mark.parametrize("metric,cell", [("graph_replay_share.train", "t2wn.train"),
                                         ("graph_replay_share.wavenet_train", "wavenet.train")])
def test_replay_share_counts_the_replays_alone(metric, cell, monkeypatch):
    """A step that captures its graph records ``train.replay`` with
    ``captured`` true and is not counted; eager steps record none."""
    read = core.module("metrics", metric).read
    traced = Run(window_s=10.0, records=[], counters={}, trace={},
                 info={"traced": {"steps": 3}})
    assert read(_run(), None) is None                  # no device trace
    assert read(traced, None) == 0.0                   # eager steps
    _recorded([("train.replay", BASE + k, BASE + k + 0.1,
                {"captured": k == 0, "shape": (4, 25597)}) for k in range(3)])
    assert read(traced, None) == pytest.approx(200.0 / 3, rel=1e-9)
    monkeypatch.setattr(profiling, "_dropped", 1)      # a part of the window
    assert read(traced, None) is None
    monkeypatch.delattr(profiling, "spans")            # a program without them
    assert read(traced, None) is None
    m = {m["name"]: m for m in core.manifest()["per_layer"]}[metric]
    assert (m["source"], m["layer"], m["workloads"]) == ("program_span", "train step", [cell])


def test_metrics_are_in_the_manifest_with_their_cells():
    per_layer = {m["name"]: m for m in core.manifest()["per_layer"]}
    cells = {"stream": "t2wn.stream", "train": "t2wn.train",
             "wavenet_train": "wavenet.train"}
    for name in METRICS:
        m = per_layer[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == [cells[name.rsplit(".", 1)[1]]]


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (spans against the device trace)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_spans_share_the_device_traces_clock(card):
    x = torch.randn(512, 512, device=card)
    with _profile(cuda=True) as prof:
        with profiling.span("warm"):
            torch.cuda.synchronize()
        for i in range(20):
            with profiling.span(f"s{i}"):
                y = x @ x
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = {e.name(): e for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA}
    kernels = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith(profiling.SPAN_PREFIX)]
    gaps = []
    for rec in profiling.spans():
        if rec.name == "warm":
            continue
        ev = host[profiling.SPAN_PREFIX + rec.name]
        gaps.append(abs(ev.start_ns() - rec.t0_ns))
    assert len(gaps) == 20 and max(gaps) < 100_000, gaps
    first = min(r.t0_ns for r in profiling.spans() if r.name != "warm")
    assert kernels and min(k.start_ns() for k in kernels) >= first
    assert y.shape == x.shape


def _traced_step(step_fn, state, data, warm, device):
    """``warm`` steps, then one step under the benchmark's ``Tracer``, each
    on a fresh copy of the batch (``data()``, made before the trace):
    the trace's summary."""
    from benchmark.harness.trace import Tracer

    for _ in range(warm):
        state, metrics = step_fn(state, data(), torch.Generator(device).manual_seed(0))
        float(metrics["loss"])
    tracer = Tracer()
    batch = data()
    tracer.start()
    state, metrics = step_fn(state, batch, torch.Generator(device).manual_seed(0))
    float(metrics["loss"])
    tracer.stop()
    return tracer.summary()


@pytest.mark.gpu
def test_tracer_counts_the_same_launches_with_and_without_spans(card, monkeypatch, tmp_path):
    """Over a Tacotron-2 step that captures its graph (a shape's second
    step) and a WaveNet step that replays one (its third), each from a
    fresh step and state, the ``Tracer`` counts the same kernels with
    spans and without. With spans the capturing step records
    ``train.replay`` (``captured`` true) and the four phases of its
    capture under it, the replay ``train.replay`` alone."""
    def taco():
        step_fn, state, batch = _train_setup(card)
        return _traced_step(step_fn, state, lambda: batch_to_device(batch, card), 1, card)

    def vocoder():
        step_fn, state, stream = _wavenet_setup(Path(tempfile.mkdtemp(dir=tmp_path)), card)
        batch = next(stream)
        stream.close()
        return _traced_step(step_fn, state, lambda: wavenet_batch_to_device(batch, card),
                            2, card)

    with_spans = {"taco": taco()}
    recs = profiling.spans()
    (replay,) = [r for r in recs if r.name == "train.replay"]
    assert sorted(replay.attrs) == ["captured", "shape"] and replay.attrs["captured"]
    # the shapes of the batch's fields: N = 2, T_in = 12, T_out = 20
    shape = replay.attrs["shape"]
    assert (shape[0], shape[3][:2], shape[4][:2]) == ((2, 12), (2, 20), (2, 20))
    phases = sorted((r for r in recs if r is not replay), key=lambda r: r.t0_ns)
    assert [r.name for r in phases] == ["train.forward", "train.backward",
                                        "train.merge", "train.update"]
    assert all(r.parent == replay.id for r in phases)
    profiling.clear()
    with_spans["vocoder"] = vocoder()
    (replay,) = profiling.spans()
    assert replay.name == "train.replay" and replay.attrs["captured"] is False
    profiling.clear()
    monkeypatch.setattr(profiling, "_torch_profiler",
                        SimpleNamespace(_is_profiler_enabled=False))
    without = {"taco": taco(), "vocoder": vocoder()}
    assert profiling.spans() == []
    for model, got in with_spans.items():
        assert got["launches"] == without[model]["launches"] > 0, model
        assert {k: v[0] for k, v in got["kernels"].items()} == {
            k: v[0] for k, v in without[model]["kernels"].items()}, model
        assert not any(k.startswith(profiling.SPAN_PREFIX) for k in got["kernels"])
        assert got["busy_s"] == pytest.approx(without[model]["busy_s"], rel=0.1), model
