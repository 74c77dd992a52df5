"""The port's benchmark harness (``nspeech_tpu_torch/cli/bench.py``) against
the JAX package's ``bench.py``, on the CPU, at tiny widths.

- The budget gate and the record, as ``tests/test_bench_budget.py`` holds
  them for ``bench.py``.
- The metric names: the port's ``_emit`` names equal ``bench.py``'s, read
  from both sources, with the sampler's two names for the CUDA kernel.
- The synthetic batches: equal to ``bench.py``'s array for array, captured
  from both benches with ``build_*_train_step`` replaced by a stub that
  records its batch (Tacotron-2, WaveNet plain and mel-conditioned).
- The first timed step: JAX's and the port's benches run their real train
  steps from the same weights (JAX's, bridged by ``convert``), dropout
  off; the first warm step's loss within 1e-5 relative and the first
  timed step's (after two Adam updates) within 1e-4, the tolerances of
  ``tests/test_torch_train_step.py``.
- ``taco2_train_step_flops`` equal to ``FlopCounterMode`` over one forward
  and backward of the port's step, exactly, once the energy-by-``v``
  product is taken out: ``energy @ v`` is a matrix-vector product, which
  the counter does not count (``aten.mv`` is not in its registry), and
  whose backward is an outer product and another one. Float32 and the
  bf16 policy, autograd and deferred weight gradients: the same count.
- The peak table, and ``main`` with its phases stubbed: the line order
  (``bench.py``'s), the CPU run, the error line without a card, and a
  failed phase that fails the run.
"""

import ast
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench as jbench
import nspeech_tpu.train.loop as jloop
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.cli import bench as tbench
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.data.feeder import Batch
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.train import loop as tloop
from nspeech_tpu_torch.train.optim import make_optimizer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TACO2 = ("encoder_conv_layers=2,postnet_conv_layers=2,expand_conv_layers=2,"
         "encoder_conv_channels=32,attention_dim=32,postnet_conv_channels=32,"
         "expand_conv_channels=32,decoder_lstm_units=32,"
         "encoder_lstm_units=16,expand_lstm_units=16,embedding_dim=32")
WAVENET = ("dilations_length=4,dilations_depth=2,residual_channels=8,"
           "dilation_channels=8,skip_channels=16,quantization_channels=128")
T_IN, T_OUT, BATCH = 12, 20, 2
RENAMES = {"wavenet_pallas_single_stream_samples_per_sec":
           "wavenet_cuda_single_stream_samples_per_sec",
           "wavenet_pallas_batch8_samples_per_sec_per_chip":
           "wavenet_cuda_batch8_samples_per_sec_per_chip"}


@pytest.fixture
def fresh_bench():
    """The port's bench with an empty headline and a clock at 0."""
    saved = dict(tbench._HEADLINE), tbench._BENCH_T0
    tbench._HEADLINE.clear()
    tbench._BENCH_T0 = time.monotonic()
    yield tbench
    tbench._HEADLINE.clear()
    tbench._HEADLINE.update(saved[0])
    tbench._BENCH_T0 = saved[1]


@pytest.fixture
def jax_precision():
    """``bench.py`` sets the global matmul precision; put it back."""
    old = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", old)


# -- the budget gate and the record (tests/test_bench_budget.py) -------------

def test_fits_gate_passes_and_skips(fresh_bench, capsys):
    assert tbench._fits(100, 50, "phase-a") is True
    assert tbench._fits(40, 50, "phase-b") is False
    err = capsys.readouterr().err
    assert "skipping phase-b" in err
    assert "phase-a" not in err


def test_fits_gate_accounts_elapsed(fresh_bench):
    tbench._BENCH_T0 = time.monotonic() - 300   # 300 s already spent
    assert tbench._fits(1140, 400, "x") is True
    assert tbench._fits(600, 400, "x") is False


def test_emit_records_headline_and_reprints(fresh_bench, capsys):
    tbench._emit("metric_one", 1.0, "u", None, "float32")
    tbench._emit("metric_two", 2.0, "u", None, "float32")
    assert tbench._HEADLINE["metric"] == "metric_one"
    out = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["metric"] for line in out] == [
        "metric_one", "metric_two"]
    assert set(json.loads(out[0])) == {"metric", "value", "unit",
                                       "vs_baseline", "precision"}


# -- the metric names --------------------------------------------------------

def emitted_names(path):
    """The string metric names of the ``_emit`` calls in ``main`` of the
    file at ``path``, in source order."""
    with open(path) as f:
        tree = ast.parse(f.read())
    consts = {t.id: n.value.value for n in tree.body if isinstance(n, ast.Assign)
              and isinstance(n.value, ast.Constant) for t in n.targets}
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "_emit"]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [consts[a.id] if isinstance(a, ast.Name) else a.value
            for a in (c.args[0] for c in calls)]


def bench_py_names():
    return [RENAMES.get(n, n) for n in emitted_names(os.path.join(ROOT, "bench.py"))]


def test_metric_names_match_bench_py():
    port = emitted_names(tbench.__file__)
    assert len(bench_py_names()) == 15
    assert port == bench_py_names()
    assert port[0] == tbench.HEADLINE_METRIC


# -- the synthetic batches ----------------------------------------------------

def stub_build(seen, loss):
    def build(*args, **kwargs):
        def step(state, batch, key=None):
            seen.append(batch)
            return state, {"loss": loss}
        return step
    return build


def capture(monkeypatch, case):
    """(JAX's batch, the port's batch) of one bench."""
    jseen, tseen = [], []
    name = ("build_tacotron_train_step" if case == "taco2"
            else "build_wavenet_train_step")
    monkeypatch.setattr(jloop, name, stub_build(jseen, jnp.zeros(())))
    monkeypatch.setattr(tbench, name, stub_build(tseen, torch.zeros(())))
    if case == "taco2":
        kw = dict(batch_size=BATCH, t_in=T_IN, t_out=T_OUT, steps=2,
                  precision="highest", hparams=TACO2)
        jbench.bench_taco2_train(**kw)
        tbench.bench_taco2_train(**kw, device="cpu")
    else:
        kw = dict(batch_size=3, sample_size=64, steps=2, precision="highest",
                  use_lc=case == "wavenet_lc", hparams=WAVENET)
        jbench.bench_wavenet_train(**kw)
        tbench.bench_wavenet_train(**kw, device="cpu")
    assert len(jseen) == len(tseen) == 5      # 2 warm, 2 + 1 timed
    return jseen[0], tseen[0]


@pytest.mark.parametrize("case", ["taco2", "wavenet", "wavenet_lc"])
def test_synthetic_batches_match_bench_py(monkeypatch, jax_precision, case):
    jb, tb = capture(monkeypatch, case)
    fields = tb._fields
    for field in fields:
        j, t = getattr(jb, field), getattr(tb, field)
        if j is None:
            assert t is None, field
            continue
        assert tuple(t.shape) == tuple(j.shape), field
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=field)
    if case == "wavenet":
        assert tb.mel_phase is None


# -- the first timed step ----------------------------------------------------

def recording(build, losses, states=None):
    """``build`` whose step records its losses (and, as numpy, the params
    and batch-norm state it starts from: JAX's step donates them)."""
    def wrapped(*args, **kwargs):
        step = build(*args, **kwargs)

        def run(state, batch, key):
            if states is not None and not states:
                states.append(jax.tree_util.tree_map(
                    np.asarray, (state.params, state.bn_state)))
            state, m = step(state, batch, key)
            losses.append(float(m["loss"]))
            return state, m
        return run
    return wrapped


def test_first_timed_step_loss_matches_jax(monkeypatch, jax_precision):
    hp = TACO2 + ",drop_rate=0.0"
    jlosses, jstates, tlosses = [], [], []
    monkeypatch.setattr(jloop, "build_tacotron_train_step",
                        recording(jloop.build_tacotron_train_step, jlosses,
                                  jstates))
    kw = dict(batch_size=BATCH, t_in=T_IN, t_out=T_OUT, steps=2,
              precision="highest", hparams=hp)
    jbench.bench_taco2_train(**kw)

    def bridged_state(model, tx, seed, device="cpu"):
        tp, ts = convert.tacotron_variables(model, *jstates[0])
        return tloop.TrainState(0, tp, ts, tx.init(tp))

    monkeypatch.setattr(tbench, "create_state", bridged_state)
    monkeypatch.setattr(tbench, "build_tacotron_train_step",
                        recording(tloop.build_tacotron_train_step, tlosses))
    tbench.bench_taco2_train(**kw, device="cpu")
    assert len(jlosses) == len(tlosses) == 5
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(tlosses[2], jlosses[2], rtol=1e-4)


# -- the FLOP count ----------------------------------------------------------

@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("extra", ["", "compute_dtype=bfloat16",
                                   "num_speakers=3,guided_attention_weight=0.5"])
def test_flops_equal_flop_counter(extra, deferred):
    cfg = load_config("taco2").parse(TACO2 + ",drop_rate=0.0," + extra)
    model = create_model("taco2", cfg)
    tx, _ = make_optimizer(cfg, "taco2")
    state = tloop.create_state(model, tx, 0)
    rng = np.random.default_rng(0)
    r = cfg.outputs_per_step
    batch = tloop.batch_to_device(Batch(
        rng.integers(2, 60, (BATCH, T_IN)).astype(np.int32),
        np.array([T_IN, T_IN - 3], np.int32), np.array([0, 2], np.int32),
        rng.random((BATCH, T_OUT, cfg.num_mels)).astype(np.float32),
        rng.random((BATCH, T_OUT, cfg.num_freq)).astype(np.float32),
        np.zeros((BATCH, 16), np.float32)), "cpu")
    with FlopCounterMode(display=False) as counter:
        tloop.tacotron_grads(model, state, batch, None, deferred_dw=deferred)
    terms = tbench.taco2_flop_terms(cfg, BATCH, T_IN, T_OUT)
    total = tbench.taco2_train_step_flops(cfg, BATCH, T_IN, T_OUT)
    assert total == sum(terms.values())
    assert ("speaker_prenet" in terms) == ("num_speakers" in extra)
    # energy @ v (aten.mv) and its backward: 3 x 2 B T_in A per step
    assert terms["attention_score"] == 6 * BATCH * T_IN * cfg.attention_dim * (
        T_OUT // r)
    assert counter.get_total_flops() == total - terms["attention_score"]
    with pytest.raises(ValueError, match="multiple"):
        tbench.taco2_flop_terms(cfg, BATCH, T_IN, T_OUT + 1)


def test_full_width_flops():
    """The count MFU divides at the bench's shapes: batch 32, 160 text
    positions, 400 frames of Tacotron-2 at its published widths."""
    cfg = load_config("taco2")
    assert tbench.taco2_train_step_flops(cfg, 32, 160, 400) == 1426515304448


def test_peak_table():
    h100 = "NVIDIA H100 80GB HBM3"
    assert tbench._chip_peak_flops("highest", name=h100) == 67e12
    assert tbench._chip_peak_flops("tensorfloat32", name=h100) == 495e12
    assert tbench._chip_peak_flops("bfloat16", name=h100) == 495e12
    for precision in ("highest", "tensorfloat32", "bfloat16"):
        assert tbench._chip_peak_flops(precision, "bfloat16", name=h100) == 989e12
    with pytest.raises(KeyError, match="NVIDIA A100-SXM4-80GB"):
        tbench._chip_peak_flops("highest", name="NVIDIA A100-SXM4-80GB")


# -- main --------------------------------------------------------------------

def stub_phases(monkeypatch, fail=None):
    """Every phase of ``main`` returns fixed numbers (``fail``: raises)."""
    calls = []

    def phase(name, value):
        def run(*args, **kwargs):
            calls.append(name)
            if name == fail:
                raise RuntimeError(f"{name} failed")
            return value
        monkeypatch.setattr(tbench, name, run)

    def taco2(*args, device="cuda", **kwargs):
        calls.append("bench_taco2_train")
        return 3000.0, 0.5, (0.004 if torch.device(device).type == "cuda"
                             else None)

    monkeypatch.setattr(tbench, "bench_taco2_train", taco2)
    phase("bench_wavenet_train", 4e5)
    phase("bench_vocoder_lc", 1.8e4)
    phase("bench_wavenet_generate", (1.8e4, 0.9))
    phase("bench_taco2_serving", (2.5, 2.4, 18.75))
    phase("bench_streaming_first_audio", (0.5, 6.0))
    return calls


def run_main(capsys, *argv):
    code = tbench.main(list(argv))
    out = capsys.readouterr()
    return code, [json.loads(line) for line in out.out.strip().splitlines()], out.err


def test_main_order_and_headline_last(fresh_bench, monkeypatch, capsys):
    stub_phases(monkeypatch)
    monkeypatch.setattr(tbench, "_require_card", lambda device: None)
    code, lines, err = run_main(capsys)
    assert code == 0
    assert [r["metric"] for r in lines[:-1]] == bench_py_names()
    assert lines[-1] == lines[0]
    assert lines[0]["metric"] == tbench.HEADLINE_METRIC
    by = {r["metric"]: r for r in lines}
    # the TPU targets are gone; the port's own ratios stay
    assert by[tbench.HEADLINE_METRIC]["vs_baseline"] is None
    assert by["taco2_stream_batch8_rt_aggregate"]["vs_baseline"] is None
    assert by["taco2_serving_sec_per_utterance_cap"]["vs_baseline"] == 7.5
    assert by["taco2_streaming_first_audio_sec"]["vs_baseline"] == 5.0
    assert by["taco2_train_mfu_bf16"]["precision"] == "bfloat16_policy"
    assert "bench: sampler launches {" in err


def test_main_cpu_runs_training_only(fresh_bench, monkeypatch, capsys):
    calls = stub_phases(monkeypatch)
    code, lines, err = run_main(capsys, "--device", "cpu")
    assert code == 0
    names = [r["metric"] for r in lines[:-1]]
    assert names == [n for n in bench_py_names()
                     if n.startswith(("taco2_train_mel", "taco2_sec",
                                      "wavenet_train"))]
    assert not any("mfu" in n for n in names)
    assert lines[-1] == lines[0]
    assert "skipping CUDA sampling / vocoder / serving metrics" in err
    assert "device is cpu" in err
    assert set(calls) == {"bench_taco2_train", "bench_wavenet_train"}


def test_main_without_card_prints_error_and_exits(fresh_bench, monkeypatch,
                                                  capsys):
    calls = stub_phases(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        tbench.main(["--device", "cuda"])
    assert exit_info.value.code == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and not calls
    rec = json.loads(lines[0])
    assert rec["metric"] == tbench.HEADLINE_METRIC and rec["value"] is None
    assert "no CUDA card" in rec["error"]


def test_main_failed_phase_fails_the_run(fresh_bench, monkeypatch, capsys):
    stub_phases(monkeypatch, fail="bench_wavenet_train")
    with pytest.raises(RuntimeError, match="bench_wavenet_train failed"):
        tbench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["metric"] for line in lines] == [
        tbench.HEADLINE_METRIC, "taco2_sec_per_step",
        "taco2_train_mel_frames_per_sec_per_chip_bf16"]
