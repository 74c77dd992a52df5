"""The port's two CLIs on the CPU.

``cli.generate_wavenet`` against the JAX package's ``generate_wavenet.py``,
end to end: a tiny JAX WaveNet is saved as an Orbax checkpoint, exported
with ``scripts/export_torch_checkpoint.py``, and both CLIs run at
temperature 0 (argmax, lowest-index tie-break on both sides) with the
same flags. The port encodes the seed wav with XLA's arithmetic and
decodes with the same ``powf`` table, so the wav files must hold the same
int16 samples (the streamed files the same bytes).

``cli.synthesize`` (and ``--long``) against the port's own ``TextToSpeech`` built from the
same weights with ``set_variables``: the same samples; and against the
JAX package's ``synthesize.py --platform cpu`` from one exported pair of
checkpoints (Tacotron-2, and a mel-conditioned vocoder at temperature 0):
the same endpoint, so the same length, and int16 samples within 4 of
32767. The Griffin-Lim phase is JAX's on both sides; its FFTs differ in
rounding, which the pipeline parity test bounds by 1e-4 of the peak (3.3
of full scale) plus one for the int16 rounding.

The ``simple_wavenet`` preset (no conditioning, M = 0) through both
generation CLIs, held to the JAX CLI's int16 samples. An exported
Tacotron-1 run through both synthesize CLIs; ``--long`` on Griffin-Lim
against ``synthesize.py --long``; ``cli.eval`` against ``eval.py`` (file
names and wav lengths; the port's PNGs decoded with ``zlib``); and the
refusals (multi-GPU, which is not ported; a vocoder beside an exported
artifact)."""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import generate_wavenet as jax_cli
import synthesize as jax_synth
from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models import create_model as j_create
from nspeech_tpu.train import CheckpointManager, create_state, make_optimizer
from nspeech_tpu.train import save_run_metadata as j_save_meta
from nspeech_tpu_torch.cli import generate_wavenet as port_cli
from nspeech_tpu_torch.cli import synthesize as port_synth
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.dsp.wavio import save_wav
from nspeech_tpu_torch.models import Tacotron2, WaveNet
from nspeech_tpu_torch.serving import Synthesizer, TextToSpeech, WaveNetVocoder
from nspeech_tpu_torch.train import save_serving_checkpoint

torch.set_num_threads(1)

TINY = ("dilations_length=3,dilations_depth=2,residual_channels=8,"
        "dilation_channels=8,skip_channels=16,quantization_channels=64,"
        "lc_channels=5,gc_channels=4,gc_category_cardinality=3")
TACO = ("max_iters=4,encoder_conv_layers=1,postnet_conv_layers=1,"
        "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
        "postnet_conv_channels=16,expand_conv_channels=16,"
        "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
        "embedding_dim=16,griffin_lim_iters=2")
TINY_SIMPLE = ("dilations_length=3,dilations_depth=2,residual_channels=8,"
               "dilation_channels=8,skip_channels=16,quantization_channels=64")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def export_jax_checkpoint(d, name, cfg, step=5, **meta):
    """Orbax checkpoint of a freshly initialised JAX model in ``d/ckpt``,
    exported to the port's archive in ``d/port``."""
    model = j_create(name, cfg)
    tx, _ = make_optimizer(cfg, name)
    state = create_state(model, tx, jax.random.PRNGKey(0))
    mgr = CheckpointManager(str(d / "ckpt"))
    mgr.save(step, state)
    mgr.wait()
    mgr.close()
    j_save_meta(str(d / "ckpt"), name, cfg, **meta)
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint",
        os.path.join(ROOT, "scripts", "export_torch_checkpoint.py"))
    exporter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exporter)
    exporter.export(str(d / "ckpt"), str(d / "port"))


def write_seed_wav(d, sr):
    rng = np.random.default_rng(0)
    t = np.arange(sr // 4) / sr
    seed = 0.5 * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.standard_normal(t.size)
    wavfile.write(str(d / "seed.wav"), sr, (seed * 32767).astype(np.int16))
    return rng


@pytest.fixture(scope="module")
def wavenet_ckpt(tmp_path_factory):
    """(Orbax checkpoint dir, exported port checkpoint dir, seed wav, mel)."""
    d = tmp_path_factory.mktemp("gen")
    cfg = j_load("wavenet").parse(TINY)
    export_jax_checkpoint(d, "wavenet", cfg)
    rng = write_seed_wav(d, cfg.sample_rate)
    np.save(str(d / "mel.npy"), rng.random((12, 5)).astype(np.float32))
    return d


def run_both(d, monkeypatch, name, flags):
    monkeypatch.setenv("NSPEECH_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(sys, "argv", [
        "generate_wavenet.py", str(d / "ckpt"), "--platform", "cpu",
        "--wav_out_path", str(d / f"{name}_jax.wav")] + flags)
    jax_cli.main()
    port_cli.main([str(d / "port"), "--device", "cpu",
                   "--wav_out_path", str(d / f"{name}_port.wav")] + flags)
    return d / f"{name}_jax.wav", d / f"{name}_port.wav"


def test_primed_generation_matches_jax_cli(wavenet_ckpt, monkeypatch, capsys):
    d = wavenet_ckpt
    j, t = run_both(d, monkeypatch, "primed", [
        "--temperature", "0", "--wav_seed", str(d / "seed.wav"),
        "--mel-npy", str(d / "mel.npy"), "--gc-id", "1", "--samples", "300"])
    out = capsys.readouterr().out
    assert out.count("Receptive field: 16") == 2
    assert out.count("Primed with 16 seed samples") == 2
    (sr_j, a), (sr_t, b) = wavfile.read(str(j)), wavfile.read(str(t))
    assert sr_j == sr_t and a.dtype == b.dtype == np.int16
    assert a.shape == b.shape == (300,) and len(np.unique(b)) > 1
    np.testing.assert_array_equal(b, a)


def test_streamed_generation_matches_jax_cli(wavenet_ckpt, monkeypatch, capsys):
    d = wavenet_ckpt
    j, t = run_both(d, monkeypatch, "stream", [
        "--temperature", "0", "--mel-npy", str(d / "mel.npy"), "--gc-id", "2",
        "--samples", "300", "--stream-chunk", "128"])
    assert capsys.readouterr().out.count("Streamed 300 samples") == 2
    assert t.read_bytes() == j.read_bytes()


def test_generation_cli_refusals(wavenet_ckpt, tmp_path):
    d = wavenet_ckpt
    with pytest.raises(SystemExit, match="wav_seed"):
        port_cli.main([str(d / "port"), "--device", "cpu", "--stream-chunk",
                       "100", "--wav_seed", str(d / "seed.wav")])
    cfg = load_config("wavenet").parse("dilations_length=2,dilations_depth=1,"
                                       "residual_channels=8,dilation_channels=8,"
                                       "skip_channels=16,quantization_channels=64")
    save_serving_checkpoint(str(tmp_path), 0, "wavenet", cfg, WaveNet(cfg).init(0))
    with pytest.raises(SystemExit, match="gc_channels"):
        port_cli.main([str(tmp_path), "--device", "cpu", "--gc-id", "1"])


@pytest.fixture(scope="module")
def tts_ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    cfg = load_config("taco2").parse(TACO)
    model = Tacotron2(cfg)
    params, bn_state = model.init(4)
    save_serving_checkpoint(str(d / "taco"), 3, "taco2", cfg, params, bn_state)
    vcfg = load_config("wavenet").parse(TINY.replace("lc_channels=5",
                                                     "lc_channels=80"))
    net = WaveNet(vcfg)
    vparams = net.init(5)
    save_serving_checkpoint(str(d / "voc"), 9, "wavenet", vcfg, vparams)
    syn = Synthesizer(cfg, device="cpu").set_variables(params, bn_state,
                                                       model=model)
    voc = WaveNetVocoder(vcfg, device="cpu").set_variables(net, vparams)
    return d, syn, voc


@pytest.mark.parametrize("vocoder,speaker", [(True, 1), (False, -1)])
def test_synthesize_cli_matches_text_to_speech(tts_ckpts, tmp_path, vocoder,
                                               speaker):
    d, syn, voc = tts_ckpts
    flags = ["--checkpoint", str(d / "taco"), "--text", "hello there",
             "--speaker", str(speaker), "--temperature", "0.7",
             "--device", "cpu", "--out", str(tmp_path / "cli.wav")]
    if vocoder:
        flags += ["--vocoder-checkpoint", str(d / "voc")]
    port_synth.main(flags)
    wav, _, _ = TextToSpeech(syn, voc if vocoder else None).synthesize(
        "hello there", speaker, temperature=0.7)
    save_wav(wav, str(tmp_path / "ref.wav"), syn.cfg.sample_rate)
    got = wavfile.read(str(tmp_path / "cli.wav"))[1]
    assert got.size > 0
    np.testing.assert_array_equal(got, wavfile.read(str(tmp_path / "ref.wav"))[1])


@pytest.mark.parametrize("flags,item", [(["--speaker", "7"], "gc id")])
def test_synthesize_cli_refusals(tts_ckpts, flags, item):
    """A speaker past the vocoder's gc table exits before any launch."""
    d, _, _ = tts_ckpts
    with pytest.raises(SystemExit, match=item):
        port_synth.main(["--checkpoint", str(d / "taco"), "--text", "hi",
                         "--vocoder-checkpoint", str(d / "voc"),
                         "--device", "cpu"] + flags)


@pytest.mark.parametrize("long", [False, True])
def test_synthesize_cli_data_parallel_matches_mesh_tts(tts_ckpts, tmp_path, long):
    """``--data-parallel`` serves over the one-process mesh of the device
    (one CPU device here): the samples of ``TextToSpeech`` over
    ``Synthesizer(mesh=...)`` and the vocoder, and of the CLI without the
    flag."""
    from nspeech_tpu_torch.parallel import make_mesh
    from nspeech_tpu_torch.serving import synthesize_long

    d, syn, voc = tts_ckpts
    text = LONG_TEXT if long else "hello there"
    flags = ["--checkpoint", str(d / "taco"), "--text", text, "--speaker", "1",
             "--vocoder-checkpoint", str(d / "voc"), "--device", "cpu"]
    flags += ["--long"] if long else ["--temperature", "0.7"]
    port_synth.main(flags + ["--data-parallel", "--out", str(tmp_path / "dp.wav")])
    port_synth.main(flags + ["--out", str(tmp_path / "plain.wav")])
    mesh_syn = Synthesizer(syn.cfg, device="cpu", mesh=make_mesh(["cpu"]))
    mesh_syn.set_variables(syn._params, syn._bn_state, model=syn.model)
    tts = TextToSpeech(mesh_syn, voc)
    if long:
        wav = synthesize_long(tts, text, 1, sample_rate=syn.cfg.sample_rate)
    else:
        wav, _, _ = tts.synthesize(text, 1, temperature=0.7)
    save_wav(wav, str(tmp_path / "ref.wav"), syn.cfg.sample_rate)
    got = wavfile.read(str(tmp_path / "dp.wav"))[1]
    assert got.size > 0
    np.testing.assert_array_equal(got, wavfile.read(str(tmp_path / "ref.wav"))[1])
    np.testing.assert_array_equal(got, wavfile.read(str(tmp_path / "plain.wav"))[1])


@pytest.mark.parametrize("argv,item", [
    (["--artifact", "exported", "--vocoder-checkpoint", "v"], "needs --checkpoint")])
def test_demo_server_refusals(argv, item):
    from nspeech_tpu_torch.cli import demo_server

    with pytest.raises(SystemExit, match=item):
        demo_server.main(argv + ["--device", "cpu"])


def test_demo_server_data_parallel_serves(tts_ckpts, monkeypatch, capsys):
    """``demo_server --data-parallel`` builds its synthesizer on the mesh
    and answers ``/synthesize`` with the WAV of the plain server."""
    import io

    from nspeech_tpu_torch.cli import demo_server

    d, syn, _ = tts_ckpts
    apps = []
    monkeypatch.setattr(demo_server, "serve_forever",
                        lambda app, port: apps.append(app))
    for extra in (["--data-parallel"], []):
        demo_server.main(["--checkpoint", str(d / "taco"), "--device", "cpu",
                          "--port", "0"] + extra)
    assert "Serving data-parallel over 1 devices" in capsys.readouterr().out
    bodies = []
    for app in apps:
        got = {}
        body = b"".join(app({"PATH_INFO": "/synthesize", "QUERY_STRING": "text=hi",
                             "wsgi.input": io.BytesIO()},
                            lambda status, headers: got.update(status=status)))
        assert got["status"].startswith("200") and body[:4] == b"RIFF"
        bodies.append(body)
    assert bodies[0] == bodies[1]


LONG_TEXT = ("Long form speech. It splits at sentences, then clauses, "
             "and joins the pieces with pauses!")


def test_synthesize_long_cli_matches_text_to_speech(tts_ckpts, tmp_path):
    """--long through the vocoder: the samples of synthesize_long over the
    same TextToSpeech (one batch of pieces, the vocoder at temperature 1,
    the port's Philox noise on both sides)."""
    from nspeech_tpu_torch.serving import synthesize_long

    d, syn, voc = tts_ckpts
    port_synth.main(["--checkpoint", str(d / "taco"), "--vocoder-checkpoint",
                     str(d / "voc"), "--text", LONG_TEXT, "--long",
                     "--pause-ms", "80", "--max-chars", "40", "--device", "cpu",
                     "--out", str(tmp_path / "cli.wav")])
    wav = synthesize_long(TextToSpeech(syn, voc), LONG_TEXT, pause_ms=80,
                          max_chars=40)
    save_wav(wav, str(tmp_path / "ref.wav"), syn.cfg.sample_rate)
    got = wavfile.read(str(tmp_path / "cli.wav"))[1]
    assert got.size > 0
    np.testing.assert_array_equal(got, wavfile.read(str(tmp_path / "ref.wav"))[1])


@pytest.fixture(scope="module")
def simple_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("simple")
    cfg = j_load("simple_wavenet").parse(TINY_SIMPLE)
    export_jax_checkpoint(d, "simple_wavenet", cfg)
    write_seed_wav(d, cfg.sample_rate)
    return d


@pytest.mark.parametrize("route,flags", [
    ("primed", ["--wav_seed", "seed.wav", "--samples", "200"]),
    ("streamed", ["--samples", "200", "--stream-chunk", "64"])])
def test_simple_wavenet_matches_jax_cli(simple_ckpt, monkeypatch, capsys,
                                        route, flags):
    """The ``simple_wavenet`` preset (lc_channels 0: the sampler's M = 0)
    is served by the port's generation CLI from an exported JAX run, as
    the JAX CLI serves it: the same int16 samples at temperature 0."""
    d = simple_ckpt
    flags = [str(d / f) if f.endswith(".wav") else f for f in flags]
    j, t = run_both(d, monkeypatch, route, ["--temperature", "0"] + flags)
    out = capsys.readouterr().out
    assert out.count("Receptive field: 16") == 2
    (_, a), (_, b) = wavfile.read(str(j)), wavfile.read(str(t))
    assert a.dtype == b.dtype == np.int16 and a.shape == b.shape == (200,)
    assert len(np.unique(b)) > 1
    np.testing.assert_array_equal(b, a)


@pytest.fixture(scope="module")
def jax_tts_ckpts(tmp_path_factory):
    """Exported JAX Tacotron-2 and mel-conditioned vocoder runs."""
    d = tmp_path_factory.mktemp("jtts")
    (d / "taco").mkdir()
    (d / "voc").mkdir()
    export_jax_checkpoint(d / "taco", "taco2", j_load("taco2").parse(TACO))
    export_jax_checkpoint(d / "voc", "wavenet", j_load("wavenet").parse(
        TINY.replace("lc_channels=5", "lc_channels=80")), step=9)
    return d


@pytest.mark.parametrize("vocoder", [False, True])
def test_synthesize_cli_matches_jax_cli(jax_tts_ckpts, tmp_path, monkeypatch,
                                        vocoder):
    """The port's synthesize CLI writes what ``synthesize.py --platform
    cpu`` writes from the same exported runs: Griffin-Lim from JAX's
    initial phase, so the same endpoint and length (with a vocoder: the
    same trimmed mel, identical codes at temperature 0)."""
    d = jax_tts_ckpts
    common = ["--text", "Hello there, two CLIs.", "--temperature", "0"]
    jflags = ["--checkpoint", str(d / "taco" / "ckpt")] + common
    tflags = ["--checkpoint", str(d / "taco" / "port")] + common
    if vocoder:
        jflags += ["--vocoder-checkpoint", str(d / "voc" / "ckpt")]
        tflags += ["--vocoder-checkpoint", str(d / "voc" / "port")]
    monkeypatch.setenv("NSPEECH_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(sys, "argv", ["synthesize.py", "--platform", "cpu",
                                      "--out", str(tmp_path / "jax.wav")] + jflags)
    jax_synth.main()
    port_synth.main(tflags + ["--device", "cpu", "--out", str(tmp_path / "port.wav")])
    (sr_j, a), (sr_t, b) = (wavfile.read(str(tmp_path / f"{n}.wav"))
                            for n in ("jax", "port"))
    assert sr_j == sr_t and a.dtype == b.dtype == np.int16
    assert a.shape == b.shape and a.size > 0
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 4


@pytest.mark.parametrize("flags", [[], ["--long", "--pause-ms", "80",
                                          "--max-chars", "40"]])
def test_synthesize_long_cli_matches_jax_cli(jax_tts_ckpts, tmp_path,
                                             monkeypatch, flags):
    """``--long`` (and the plain route) on Griffin-Lim from one exported
    run: the JAX CLI's pieces, pauses and endpoints, so the same length,
    int16 within 4."""
    d = jax_tts_ckpts
    common = ["--text", LONG_TEXT] + flags
    monkeypatch.setenv("NSPEECH_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(sys, "argv", [
        "synthesize.py", "--platform", "cpu", "--out", str(tmp_path / "jax.wav"),
        "--checkpoint", str(d / "taco" / "ckpt")] + common)
    jax_synth.main()
    port_synth.main(["--checkpoint", str(d / "taco" / "port"), "--device", "cpu",
                     "--out", str(tmp_path / "port.wav")] + common)
    a, b = (wavfile.read(str(tmp_path / f"{n}.wav"))[1] for n in ("jax", "port"))
    assert a.shape == b.shape and a.size > 0
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 4


TACO1 = ("max_iters=4,encoder_cbhg_banks=2,post_cbhg_banks=2,attention_dim=16,"
         "decoder_dim=16,embedding_dim=16,griffin_lim_iters=2")


@pytest.mark.parametrize("vocoder", [False, True])
def test_taco1_synthesize_cli_matches_jax_cli(jax_tts_ckpts, tmp_path,
                                              monkeypatch, vocoder):
    """An exported Tacotron-1 run serves through the port's synthesize
    CLI as through ``synthesize.py``: same length, int16 within 4 (with a
    vocoder: identical codes at temperature 0)."""
    d = jax_tts_ckpts
    if not (d / "taco1" / "port").exists():
        (d / "taco1").mkdir(exist_ok=True)
        export_jax_checkpoint(d / "taco1", "taco1", j_load("taco1").parse(TACO1))
    common = ["--text", "Tacotron one, served.", "--temperature", "0"]
    if vocoder:
        jvoc = ["--vocoder-checkpoint", str(d / "voc" / "ckpt")]
        tvoc = ["--vocoder-checkpoint", str(d / "voc" / "port")]
    else:
        jvoc = tvoc = []
    monkeypatch.setenv("NSPEECH_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(sys, "argv", [
        "synthesize.py", "--platform", "cpu", "--out", str(tmp_path / "jax.wav"),
        "--checkpoint", str(d / "taco1" / "ckpt")] + common + jvoc)
    jax_synth.main()
    port_synth.main(["--checkpoint", str(d / "taco1" / "port"), "--device", "cpu",
                     "--out", str(tmp_path / "port.wav")] + common + tvoc)
    a, b = (wavfile.read(str(tmp_path / f"{n}.wav"))[1] for n in ("jax", "port"))
    assert a.shape == b.shape and a.size > 0
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 4


def read_png_gray8(path):
    """The pixels of an 8-bit grayscale PNG without filters, decoded with
    zlib."""
    import struct
    import zlib

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunks.setdefault(kind, b"")
        chunks[kind] += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and color == 0
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, w + 1)
    assert not rows[:, 0].any()
    return rows[:, 1:]


def test_eval_cli_writes_what_eval_py_writes(jax_tts_ckpts, tmp_path, monkeypatch):
    """The port's eval CLI against ``eval.py --platform cpu`` on one
    exported run (Griffin-Lim): the same file names, wav lengths within
    the endpoint's tolerance (equal here), and spectrogram PNGs whose
    pixels are the port's own mel and linear, min-max scaled."""
    import eval as jax_eval

    from nspeech_tpu_torch.cli import eval as port_eval
    from nspeech_tpu_torch.utils.plot import specgram_image

    d = jax_tts_ckpts
    monkeypatch.setenv("NSPEECH_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(sys, "argv", [
        "eval.py", "--platform", "cpu", "--checkpoint", str(d / "taco" / "ckpt"),
        "--skip-harvard", "--text-bucket", "128",
        "--output-dir", str(tmp_path / "jax")])
    jax_eval.main()
    port_eval.main(["--checkpoint", str(d / "taco" / "port"), "--skip-harvard",
                    "--text-bucket", "128", "--device", "cpu",
                    "--output-dir", str(tmp_path / "port")])
    jnames = sorted(p.name for p in (tmp_path / "jax").iterdir())
    tnames = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert tnames == jnames and len(tnames) == 24
    for name in tnames:
        if name.endswith(".wav"):
            a = wavfile.read(str(tmp_path / "jax" / name))[1]
            b = wavfile.read(str(tmp_path / "port" / name))[1]
            assert a.shape == b.shape and a.size > 0
    syn = Synthesizer.from_checkpoint(str(d / "taco" / "port"), device="cpu",
                                      text_bucket=128)
    _, mel, lin = syn.synthesize(port_eval.sentences[3])
    for suffix, spec in (("-lin.png", lin), ("-mel.png", mel)):
        pixels = read_png_gray8(str(tmp_path / "port" / f"eval-latest-3{suffix}"))
        assert pixels.shape == (spec.shape[1], spec.shape[0])
        np.testing.assert_array_equal(pixels, specgram_image(spec))


def test_eval_harvard_selection_matches_eval_py(tmp_path):
    """Harvard groups 1-3 (30 sentences, headers skipped, indices
    stripped), read from the port's own copy of the list."""
    import eval as jax_eval

    from nspeech_tpu_torch.cli import eval as port_eval

    class Stub:
        def __init__(self):
            self.texts = []

        def synthesize(self, text, speaker_id):
            self.texts.append(text)
            return (np.zeros(100, np.float32), np.random.rand(4, 80),
                    np.random.rand(4, 1025))

    cfg = load_config("taco2")
    args = type("Args", (), {"speaker": -1})()
    j, t = Stub(), Stub()
    jax_eval.harvard_eval(args, j, cfg, str(tmp_path / "j"))
    port_eval.harvard_eval(args, t, cfg, str(tmp_path / "t"))
    assert t.texts == j.texts and len(t.texts) == 30
    assert (sorted(p.name for p in tmp_path.glob("t-*"))
            == sorted(p.name.replace("j-", "t-", 1) for p in tmp_path.glob("j-*")))


@pytest.mark.parametrize("argv", [
    ["generate", "--gc-id", "3"], ["generate", "--gc-id", "-1"],
    ["synthesize", "--speaker", "3"]])
def test_cli_refuses_ids_outside_tables(wavenet_ckpt, tts_ckpts, argv):
    """An id past the gc table (cardinality 3) stops either CLI before
    anything runs, with the id in the message."""
    if argv[0] == "generate":
        main, flags = port_cli.main, [str(wavenet_ckpt / "port")]
    else:
        d, _, _ = tts_ckpts
        main, flags = port_synth.main, [
            "--checkpoint", str(d / "taco"), "--vocoder-checkpoint",
            str(d / "voc"), "--text", "hi"]
    with pytest.raises(SystemExit, match=r"out of range \[0, 3\)"):
        main(flags + argv[1:] + ["--device", "cpu"])
