"""The port's trained-run tools held to the JAX package's scripts, on the CPU.

The scripts under ``scripts/`` are loaded through ``importlib`` (as
``tests/test_multispeaker.py`` loads them) and run on the same weights and
inputs as the port's CLIs under ``nspeech_tpu_torch/cli/``:

- ``utils/audio_metrics.py``: every function against its twin in
  ``scripts/alignment_report.py`` or ``scripts/vocoder_report.py`` on
  seeded numpy inputs, within 1e-12; ``mel_l1`` runs each package's
  featurizer, whose mels differ by up to ~1.5e-5, and is held within 1e-5.
- ``make_alignment_corpus``: the same arguments write the same bytes, in
  the LJSpeech and VCTK (2 speakers) layouts.
- ``alignment_report``: a tiny JAX Tacotron-2 (2 speakers) saved with
  Orbax and exported to the port (``scripts/export_torch_checkpoint.py``):
  decoder steps and monotonicity equal, sharpness and RMS within 1e-5,
  seconds equal, the final smoothed sharpness equal; with ``--speakers``
  the gated ratios null where JAX's are.
- ``vocoder_report``: a tiny WaveNet (lc 80, gc 4 over 2 speakers) the same
  way: teacher-forced nll and waveform correlation within 1e-5, its
  integer fields equal; copy synthesis (<= 1,000 samples) and end to end
  at temperature 0 emit the same codes as JAX's scan generator (argmax,
  lowest-index tie-break), so their mel L1s agree within 1e-5.
- ``gta_mismatch`` on the port's GTA export: the same JSON within 1e-5
  (``tests/test_torch_gta.py``'s feature tolerance).
- ``serve_latency``: the same keys and decoder steps per text at both
  thresholds (times are not compared).
- ``exposure_report``: the same table on synthetic ``metrics.jsonl`` files.
- ``plot_curves``: a valid PNG (signature, IHDR size, zlib payload size).
- No new module imports ``jax``, ``nspeech_tpu`` or ``matplotlib``.
"""

import importlib.util
import json
import os
import struct
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models import create_model as j_create
from nspeech_tpu.train import CheckpointManager as JCheckpointManager
from nspeech_tpu.train import create_state as j_create_state
from nspeech_tpu.train import make_optimizer as j_make_optimizer
from nspeech_tpu.train import save_run_metadata as j_save_meta
from nspeech_tpu_torch.cli import alignment_report as t_align
from nspeech_tpu_torch.cli import exposure_report as t_expo
from nspeech_tpu_torch.cli import gta_mismatch as t_gta
from nspeech_tpu_torch.cli import make_alignment_corpus as t_corpus
from nspeech_tpu_torch.cli import serve_latency as t_latency
from nspeech_tpu_torch.cli import vocoder_report as t_vocoder
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.data.gta import export_gta
from nspeech_tpu_torch.utils import audio_metrics as am
from nspeech_tpu_torch.utils.plot import plot_curves

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
TACO = ("max_iters=2,encoder_conv_layers=1,postnet_conv_layers=1,"
        "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
        "postnet_conv_channels=16,expand_conv_channels=16,"
        "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
        "embedding_dim=16,griffin_lim_iters=2")
WAVENET = ("dilations_length=3,dilations_depth=2,residual_channels=8,"
           "dilation_channels=8,skip_channels=16,quantization_channels=64,"
           "lc_channels=80,gc_channels=4,gc_category_cardinality=2")
TOL = 1e-5
EXACT = 1e-12
NEW_MODULES = ["nspeech_tpu_torch.utils.audio_metrics",
               "nspeech_tpu_torch.utils.plot"] + [
    "nspeech_tpu_torch.cli." + m for m in (
        "make_alignment_corpus", "alignment_report", "exposure_report",
        "gta_mismatch", "serve_latency", "vocoder_report")]


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_ALIGN = load_script("alignment_report")
J_VOC = load_script("vocoder_report")
J_CORPUS = load_script("make_alignment_corpus")


def run_jax_main(module, argv, monkeypatch, capsys):
    """A JAX script's ``main()`` with ``argv``, its printed JSON parsed."""
    monkeypatch.setenv("NSPEECH_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(sys, "argv", ["script"] + argv)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


def first_json(out: str):
    return json.JSONDecoder().raw_decode(out[out.index("{"):])[0]


def export_jax(d, name, cfg, speaker_map=None):
    """A freshly initialised JAX model as an Orbax checkpoint in
    ``d/jax/ckpt`` and as the port's checkpoint in ``d/port/ckpt``."""
    model = j_create(name, cfg)
    tx, _ = j_make_optimizer(cfg, name)
    state = j_create_state(model, tx, jax.random.PRNGKey(0))
    ckpt = str(d / "jax" / "ckpt")
    mgr = JCheckpointManager(ckpt)
    mgr.save(3, state)
    mgr.wait()
    mgr.close()
    j_save_meta(ckpt, name, cfg, speaker_map=speaker_map)
    exporter = load_script("export_torch_checkpoint")
    exporter.export(ckpt, str(d / "port" / "ckpt"))
    return str(d / "jax"), str(d / "port")


def write_metrics(run_dir, rows):
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "metrics.jsonl"), "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("aln") / "corpus")
    t_corpus.make_corpus(out, 3, seed=29, style="chars")
    return out


@pytest.fixture(scope="module")
def taco_runs(tmp_path_factory):
    """(JAX run dir, port run dir) of a tiny 2-speaker Tacotron-2, with the
    same seeded metrics.jsonl (attention_sharpness every 10 steps)."""
    d = tmp_path_factory.mktemp("taco")
    cfg = j_load("taco2").parse(TACO)
    cfg.num_speakers = 2
    jrun, prun = export_jax(d, "taco2", cfg,
                            speaker_map={("ljspeech", "0"): 0, ("ljspeech", "1"): 1})
    rng = np.random.default_rng(5)
    rows = [{"step": 10 * i, "loss": float(rng.random()),
             "attention_sharpness": float(rng.random())} for i in range(1, 90)]
    for run in (jrun, prun):
        write_metrics(run, rows)
    return jrun, prun


@pytest.fixture(scope="module")
def wavenet_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wn")
    jrun, prun = export_jax(d, "wavenet", j_load("wavenet").parse(WAVENET))
    rows = [{"step": s, "loss": 5.0 - 0.01 * s} for s in range(0, 50, 5)]
    for run in (jrun, prun):
        write_metrics(run, rows)
    return jrun, prun


# -- pure measurements ------------------------------------------------------

def _wav(seed, n=6000, sr=20000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = rng.uniform(150, 400)
    return (0.4 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(4 * np.pi * f0 * t)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


METRIC_CASES = {
    "monotonicity": lambda m: m.monotonicity(
        np.random.default_rng(1).random((12, 30)), 25),
    "median_f0": lambda m: m.median_f0(_wav(2), 20000),
    "spectral_centroid": lambda m: m.spectral_centroid(_wav(3), 20000),
    "spectral_shift_ratio": lambda m: m.spectral_shift_ratio(_wav(4), _wav(5), 20000),
    "dominant_freq_track": lambda m: m.dominant_freq_track(_wav(6), 20000),
    "track_agreement": lambda m: m.track_agreement(
        m.dominant_freq_track(_wav(7), 20000), m.dominant_freq_track(_wav(8), 20000),
        tol_hz=120.0),
    "spectral_cosine": lambda m: m.spectral_cosine(_wav(9), _wav(10), 20000),
    "log_spectral_centroid": lambda m: m.log_spectral_centroid(_wav(11), 20000),
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_audio_metric_matches_jax(name):
    twin = J_VOC if hasattr(J_VOC, name) else J_ALIGN
    got = np.asarray(METRIC_CASES[name](am), np.float64)
    want = np.asarray(METRIC_CASES[name](twin), np.float64)
    assert got.shape == want.shape and got.size
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)


def test_sharpness_smoothing_matches_jax(taco_runs, tmp_path):
    jrun, prun = taco_runs
    want = J_ALIGN.sharpness_curve(jrun, str(tmp_path / "j.png"))
    got = t_align.sharpness_curve(prun, str(tmp_path / "t.png"))
    assert abs(got - want) <= EXACT
    _, sharp = t_align.read_metric(prun, "attention_sharpness")
    k, smooth = am.smooth_sharpness(sharp)
    assert k == len(sharp) // 40 == 2 and len(smooth) == len(sharp) - 1


def test_mel_l1_matches_jax():
    cfg_j, cfg_t = j_load("taco2"), load_config("taco2")
    wav = _wav(12, n=5000)
    ref = np.random.default_rng(13).random((30, 80)).astype(np.float32)
    assert abs(am.mel_l1(wav, ref, cfg_t) - J_VOC.mel_l1(wav, ref, cfg_j)) <= TOL


# -- corpus -------------------------------------------------------------------

def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("speakers,style", [(1, "chars"), (2, "formant")])
def test_corpus_bytes_match_jax(tmp_path, speakers, style):
    J_CORPUS.make_corpus(str(tmp_path / "j"), 3, seed=7, style=style,
                         speakers=speakers)
    assert t_corpus.main([str(tmp_path / "t"), "3", "7", style, str(speakers),
                          "--device", "cpu"]) == 0
    j, t = _tree_bytes(tmp_path / "j"), _tree_bytes(tmp_path / "t")
    assert sorted(t) == sorted(j) and len(t) >= 3
    assert ("metadata.csv" in t) == (speakers == 1)
    assert all(t[k] == j[k] for k in j)


# -- alignment_report ---------------------------------------------------------

@pytest.mark.parametrize("speakers", ["", "0,1"])
def test_alignment_report_matches_jax(taco_runs, tmp_path, monkeypatch, capsys,
                                      speakers):
    jrun, prun = taco_runs
    texts = ["kit ypdioo asxyt.", "qs qcwpkg."]
    flags = sum([["--text", t] for t in texts], [])
    if speakers:
        flags += ["--speakers", speakers]
    run_jax_main(J_ALIGN, ["--run-dir", jrun, "--out", str(tmp_path / "j"),
                           "--platform", "cpu"] + flags, monkeypatch, capsys)
    assert t_align.main(["--run-dir", prun, "--out", str(tmp_path / "t"),
                         "--device", "cpu"] + flags) == 0
    j = json.load(open(tmp_path / "j" / "report.json"))
    t = json.load(open(tmp_path / "t" / "report.json"))
    assert abs(t["final_sharpness_smoothed"] - j["final_sharpness_smoothed"]) <= EXACT
    assert len(t["texts"]) == len(j["texts"]) == 2
    for et, ej in zip(t["texts"], j["texts"]):
        assert sorted(et) == sorted(ej)
        pairs = ([(et, ej)] if not speakers else
                 [(et["per_speaker"][k], ej["per_speaker"][k])
                  for k in ej["per_speaker"]])
        for a, b in pairs:
            assert sorted(a) == sorted(b)
            assert a["decoder_steps"] == b["decoder_steps"]
            assert a["monotonicity"] == b["monotonicity"]
            assert a["seconds"] == b["seconds"]
            for k in ("sharpness", "rms"):
                assert abs(a[k] - b[k]) <= TOL, (k, a[k], b[k])
        for key in ("f0_ratio_vs_first_speaker", "spectral_ratio_vs_first_speaker",
                    "centroid_ratio_vs_first_speaker"):
            if key in ej:
                assert [v is None for v in et[key]] == [v is None for v in ej[key]]
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))


# -- vocoder_report -----------------------------------------------------------

@pytest.mark.parametrize("speakers", ["", "0,1"])
def test_vocoder_report_matches_jax(taco_runs, wavenet_runs, corpus, tmp_path,
                                    monkeypatch, capsys, speakers):
    (jt, pt), (jw, pw) = taco_runs, wavenet_runs
    flags = ["--corpus", corpus, "--n-copy", "1", "--copy-seconds", "0.05",
             "--tf-window", "400", "--temperature", "0", "--texts", "kit yp."]
    if speakers:
        flags += ["--speakers", speakers]
    else:
        flags += ["--sweep", "0"]
    monkeypatch.syspath_prepend(SCRIPTS)   # the --speakers route's import
    run_jax_main(J_VOC, ["--taco-run", jt, "--wavenet-run", jw, "--out",
                         str(tmp_path / "j"), "--no-pallas"] + flags,
                 monkeypatch, capsys)
    assert t_vocoder.main(["--taco-run", pt, "--wavenet-run", pw, "--out",
                           str(tmp_path / "t"), "--device", "cpu"] + flags) == 0
    j = json.load(open(tmp_path / "j" / "report.json"))
    t = json.load(open(tmp_path / "t" / "report.json"))
    assert sorted(t) == sorted(j)
    assert (t["train_final_step"], t["train_final_nll"]) == (
        j["train_final_step"], j["train_final_nll"])
    tj, tt = j["teacher_forced"], t["teacher_forced"]
    for k in ("window_samples", "median_abs_code_err"):
        assert tt[k] == tj[k]
    for k in ("nll", "waveform_corr", "argmax_within_2_codes"):
        assert abs(tt[k] - tj[k]) <= TOL, (k, tt[k], tj[k])
    # the same codes: the generated wavs are equal sample for sample
    import scipy.io.wavfile as wavfile

    for name in sorted(os.listdir(tmp_path / "j")):
        if name.endswith(".wav"):
            a = wavfile.read(str(tmp_path / "j" / name))[1]
            b = wavfile.read(str(tmp_path / "t" / name))[1]
            if "griffinlim" in name:
                assert a.shape == b.shape
            else:
                np.testing.assert_array_equal(b, a, err_msg=name)
    cj, ct = j["copy_synthesis"][0], t["copy_synthesis"][0]
    assert sorted(ct) == sorted(cj)
    assert abs(ct["mel_l1"] - cj["mel_l1"]) <= TOL
    if speakers:
        ej, et = j["end_to_end_speakers"][0], t["end_to_end_speakers"][0]
        for s in ("0", "1"):
            a, b = et["speakers"][s], ej["speakers"][s]
            assert sorted(a) == sorted(b) and a["seconds"] == b["seconds"]
            assert abs(a["wavenet_mel_l1_vs_predicted"]
                       - b["wavenet_mel_l1_vs_predicted"]) <= TOL
    else:
        ej, et = j["end_to_end"][0], t["end_to_end"][0]
        assert sorted(et) == sorted(ej) and et["seconds"] == ej["seconds"]
        assert abs(et["wavenet_mel_l1_vs_predicted"]
                   - ej["wavenet_mel_l1_vs_predicted"]) <= TOL
        assert abs(ct["sweep"]["0.0"]["mel_l1"] - cj["sweep"]["0.0"]["mel_l1"]) <= TOL


# -- gta_mismatch, serve_latency, exposure_report -----------------------------

def test_gta_mismatch_matches_jax(taco_runs, corpus, tmp_path, monkeypatch, capsys):
    _, prun = taco_runs
    gta = str(tmp_path / "gta")
    export_gta(os.path.join(prun, "ckpt"), {"ljspeech": corpus}, gta,
               device="cpu", log=lambda *_: None)
    flags = ["--gta-dir", gta, "--ljspeech", corpus]
    monkeypatch.setattr(sys, "argv", ["gta_mismatch"])
    assert load_script("gta_mismatch").main(flags + ["--platform", "cpu"]) == 0
    j = first_json(capsys.readouterr().out)
    assert t_gta.main(flags + ["--device", "cpu"]) == 0
    t = first_json(capsys.readouterr().out)
    assert sorted(t) == sorted(j) and t["n_utterances"] == j["n_utterances"] == 3
    assert (t["checkpoint"], t["step"]) == (j["checkpoint"], j["step"])
    for k in ("mel_l1_mean", "mel_l1_p50", "mel_l1_p90", "mel_l1_max"):
        assert abs(t[k] - j[k]) <= TOL, (k, t[k], j[k])


def test_serve_latency_matches_jax(taco_runs, capsys):
    jrun, prun = taco_runs
    flags = ["--threshold", "0.3", "--text", "kit ypdioo.", "--text", "qs qcw."]
    os.environ["NSPEECH_NO_COMPILE_CACHE"] = "1"
    try:
        assert load_script("serve_latency").main(
            ["--checkpoint", os.path.join(jrun, "ckpt"), "--platform", "cpu"]
            + flags) == 0
    finally:
        del os.environ["NSPEECH_NO_COMPILE_CACHE"]
    j = first_json(capsys.readouterr().out)
    assert t_latency.main(["--checkpoint", os.path.join(prun, "ckpt"),
                           "--device", "cpu"] + flags) == 0
    t = first_json(capsys.readouterr().out)
    assert sorted(t) == sorted(j)
    for label in ("cap", "calibrated"):
        assert t[label]["stop_threshold"] == j[label]["stop_threshold"]
        steps = [(r["text"], r["decoder_steps"], r["audio_sec"])
                 for r in t[label]["rows"]]
        assert steps == [(r["text"], r["decoder_steps"], r["audio_sec"])
                         for r in j[label]["rows"]]
        assert all(sorted(r) == ["audio_sec", "decoder_steps", "sec", "text"]
                   for r in t[label]["rows"])


def test_exposure_report_matches_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(3)
    runs = []
    for label in ("ss0.0", "ss0.5"):
        d = str(tmp_path / label)
        rows = [{"step": s, "loss": 1.0} for s in range(0, 40, 10)]
        rows += [{"step": s, "freerun_rms": float(rng.uniform(0, 0.1)),
                  "freerun_decoder_steps": int(rng.integers(5, 50))}
                 for s in (300, 100, 200)]
        write_metrics(d, rows)
        runs += ["--run", f"{label}={d}"]
    run_jax_main(load_script("exposure_report"),
                 runs + ["--out", str(tmp_path / "j")], monkeypatch, capsys)
    assert t_expo.main(runs + ["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    j = json.load(open(tmp_path / "j" / "report.json"))
    t = json.load(open(tmp_path / "t" / "report.json"))
    assert t == j
    assert [p["step"] for p in t["runs"]["ss0.0"]["points"]] == [100, 200, 300]
    assert os.path.exists(tmp_path / "t" / "freerun_rms.png")


# -- plot_curves, imports -----------------------------------------------------

def test_plot_curves_writes_valid_png(tmp_path):
    path = str(tmp_path / "c.png")
    plot_curves(path, [("a", [0, 1, 2, 3], [1.0, 3.0, float("nan"), 2.0]),
                       ("ref", [0, 3], [2.0, 2.0])], "step", "loss")
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, pos = {}, 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n: pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks.setdefault(kind, []).append(body)
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][0][:10])
    assert (depth, colour) == (8, 2) and w > 100 and h > 100
    raw = zlib.decompress(b"".join(chunks[b"IDAT"]))
    assert len(raw) == h * (1 + 3 * w)
    pixels = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)[:, 1:]
    assert (pixels.reshape(h, w, 3) == (31, 119, 180)).all(-1).any()
    assert b"ref: #ff7f0e" in b"".join(chunks[b"tEXt"])


def test_new_modules_import_no_jax():
    code = ("import sys, importlib\n"
            f"for m in {NEW_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m.startswith('nspeech_tpu.') or m == 'nspeech_tpu'\n"
            "       or m.split('.')[0] == 'matplotlib']\n"
            "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
