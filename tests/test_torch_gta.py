"""The port's GTA export (``data/gta.py``, ``cli.export_gta``) and the
window feeder's GTA mode, on the CPU: the cases of ``tests/test_gta.py``
on the port (the anchor grid, a fingerprint mismatch and a missing or
stale mel refused, a multi-speaker export through the checkpoint's
speaker map, export then train on the windows), and the port's export
held to the JAX package's from the same Tacotron-2 weights: the same file
names and manifest, mels within 1e-5 absolute (teacher-forced forwards of
two packages on mel targets within the featurizer's 1e-5; found: 2.6e-8),
and from a ``compute_dtype=bfloat16`` checkpoint within JAX's bf16 bound
of JAX's float32 export.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.data.gta import export_gta as j_export
from nspeech_tpu.models import create_model as j_create
from nspeech_tpu.train import CheckpointManager as JCheckpointManager
from nspeech_tpu.train import create_state as j_create_state
from nspeech_tpu.train import make_optimizer as j_make_optimizer
from nspeech_tpu.train import save_run_metadata as j_save_meta
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.cli import export_gta as gta_cli
from nspeech_tpu_torch.cli import train_wavenet as wn_cli
from nspeech_tpu_torch.config import load_config, stft_params
from nspeech_tpu_torch.data.corpus import load_items
from nspeech_tpu_torch.data.gta import (check_fingerprint, export_gta,
                                        fingerprint, gta_path)
from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder
from nspeech_tpu_torch.dsp.trim import trim_silence
from nspeech_tpu_torch.dsp.wavio import load_wav
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.train import save_run_metadata, save_serving_checkpoint

from tests.make_synth_corpus import make_corpus

torch.set_num_threads(1)

TACO1 = ("batch_size=2,batch_group_size=2,max_iters=3,encoder_cbhg_banks=1,"
         "post_cbhg_banks=1,attention_dim=16,decoder_dim=16,embedding_dim=16")
TACO2 = ("max_iters=4,encoder_conv_layers=1,postnet_conv_layers=1,"
         "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
         "postnet_conv_channels=16,expand_conv_channels=16,"
         "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
         "embedding_dim=16")
GTA_TOL = 1e-5
BF16_TOL = 0.05         # tests/test_mixed_precision.py's bf16 bound
BF16_GAP_FACTOR = 2.0   # as tests/test_torch_policy.py
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda *_: None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("gta_corpus")), n=4)


def write_manifest(gta_dir, cfg, files):
    os.makedirs(gta_dir, exist_ok=True)
    with open(os.path.join(gta_dir, "manifest.json"), "w") as f:
        json.dump({"fingerprint": fingerprint(cfg), "files": files,
                   "model": "test", "checkpoint": "none", "step": None,
                   "count": len(files)}, f)


def taco1_checkpoint(ckpt_dir, extra="", speaker_map=None):
    """A freshly initialised tiny Tacotron-1 as the port's serving
    checkpoint (step 0)."""
    cfg = load_config("taco1").parse(TACO1 + extra)
    cfg.encoder_prenet = [16, 16]
    cfg.encoder_cbhg_bank_sizes = [16]
    cfg.post_cbhg_bank_sizes = [80]
    params, state = create_model("taco1", cfg).init(0)
    save_serving_checkpoint(ckpt_dir, 0, "taco1", cfg, params, state,
                            speaker_map=speaker_map)
    return cfg


def test_gta_anchor_grid_exact(corpus, tmp_path):
    """A ramp (mel[i, :] = i) as every GTA mel: after the silence-pad
    splice and the per-sample upsample, sample s of the padded waveform
    reads s/hop - pad_rows, a pad that is no hop multiple rounded up."""
    cfg = load_config("wavenet").parse("batch_size=2,sample_size=1000")
    _, hop, _ = stft_params(cfg)
    rf = 3 * hop + 17
    gta_dir = str(tmp_path / "gta")
    files = {}
    for wav_path, _t, _s, _d in load_items({"ljspeech": corpus}):
        wav = trim_silence(load_wav(wav_path, cfg.sample_rate), cfg.silence_threshold)
        ramp = np.tile(np.arange(1 + len(wav) // hop, dtype=np.float32)[:, None],
                       (1, cfg.num_mels))
        os.makedirs(gta_dir, exist_ok=True)
        np.save(gta_path(gta_dir, wav_path), ramp)
        files[os.path.abspath(wav_path)] = os.path.basename(gta_path(gta_dir, wav_path))
    write_manifest(gta_dir, cfg, files)
    feeder = WaveNetFeeder({"ljspeech": corpus}, rf, cfg, frame_lc=False,
                           gta_dir=gta_dir)
    pad = feeder._gta_pad
    assert pad % hop == 0 and pad >= rf
    pad_rows = pad // hop
    lc = next(feeder.batches()).mel[0]
    expected = np.arange(feeder.window) / hop - pad_rows
    region = expected >= 0
    np.testing.assert_allclose(lc[region, 0], expected[region], atol=1e-5)
    for j in range(pad_rows):
        np.testing.assert_allclose(lc[j * hop, 0], lc[0, 0], atol=1e-6)


def test_gta_fingerprint_mismatch_rejected(corpus, tmp_path):
    cfg = load_config("wavenet")
    gta_dir = str(tmp_path / "gta")
    write_manifest(gta_dir, cfg, {})
    other = load_config("wavenet")
    other.num_mels = cfg.num_mels + 1
    with pytest.raises(ValueError, match="num_mels"):
        check_fingerprint(gta_dir, other)
    with pytest.raises(ValueError, match="feature hparams"):
        WaveNetFeeder({"ljspeech": corpus}, 256, other, gta_dir=gta_dir)


def test_gta_missing_or_stale_mel_rejected(corpus, tmp_path):
    cfg = load_config("wavenet").parse("batch_size=2,sample_size=1000")
    gta_dir = str(tmp_path / "gta")
    write_manifest(gta_dir, cfg, {})
    feeder = WaveNetFeeder({"ljspeech": corpus}, 512, cfg, gta_dir=gta_dir)
    with pytest.raises(FileNotFoundError, match="export_gta"):
        next(feeder.batches())
    for wav_path, _t, _s, _d in load_items({"ljspeech": corpus}):
        np.save(gta_path(gta_dir, wav_path), np.zeros((3, cfg.num_mels), np.float32))
    with pytest.raises(ValueError, match="frames"):
        next(feeder.batches())


def test_export_multispeaker_uses_persisted_map(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "mac", os.path.join(ROOT, "scripts", "make_alignment_corpus.py"))
    mac = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mac)
    corpus = {"vctk": mac.make_corpus(str(tmp_path / "c"), n=6, seed=5,
                                      style="words", speakers=2)}
    speakers = sorted({(i[3], str(i[2])) for i in load_items(corpus)})
    assert len(speakers) == 2
    ckpt = str(tmp_path / "ckpt")
    cfg = taco1_checkpoint(ckpt, ",num_speakers=2")
    # a map that holds only one of the corpus's two speakers
    save_run_metadata(ckpt, "taco1", cfg, speaker_map={speakers[0]: 0})
    with pytest.raises(ValueError, match="speaker map"):
        export_gta(ckpt, corpus, str(tmp_path / "g1"), batch_size=2,
                   text_bucket=16, frame_bucket=32, device="cpu", **QUIET)
    save_run_metadata(ckpt, "taco1", cfg,
                      speaker_map={speakers[0]: 1, speakers[1]: 0})
    manifest = export_gta(ckpt, corpus, str(tmp_path / "g2"), batch_size=2,
                          text_bucket=16, frame_bucket=32, device="cpu", **QUIET)
    assert manifest["count"] == 6


def test_export_then_train_windows(corpus, tmp_path, capsys):
    """A tiny Tacotron-1 checkpoint, ``cli.export_gta`` over the corpus,
    then ``cli.train_wavenet --gta-dir`` for one step."""
    ckpt = str(tmp_path / "ckpt")
    cfg = taco1_checkpoint(ckpt, speaker_map={("ljspeech", "0"): 0})
    out_dir = str(tmp_path / "gta")
    gta_cli.main(["--device", "cpu", "--checkpoint", ckpt, "--ljspeech", corpus,
                  "--out-dir", out_dir, "--batch-size", "2", "--text-bucket",
                  "16", "--frame-bucket", "32"])
    assert "Wrote 4 GTA mels" in capsys.readouterr().out
    _, hop, _ = stft_params(cfg)
    for wav_path, _t, _s, _d in load_items({"ljspeech": corpus}):
        mel = np.load(gta_path(out_dir, wav_path))
        wav = trim_silence(load_wav(wav_path, 20000), cfg.silence_threshold)
        assert mel.shape == (1 + len(wav) // hop, cfg.num_mels)
        assert np.isfinite(mel).all()
    wn = ("batch_size=2,sample_size=1000,lc_channels=80,dilations_length=4,"
          "dilations_depth=2,residual_channels=8,dilation_channels=8,"
          "skip_channels=16,quantization_channels=128")
    feeder = WaveNetFeeder({"ljspeech": corpus}, 1026,
                           load_config("wavenet").parse(wn), gta_dir=out_dir)
    batch = next(feeder.batches())
    assert batch.audio.shape == (2, 2026) and batch.mel_phase is not None
    assert np.isfinite(batch.mel).all()
    wn_cli.main(["--device", "cpu", "--ljspeech", corpus, "--log-dir",
                 str(tmp_path / "logs"), "--gta-dir", out_dir, "--max-steps", "1",
                 "--hparams", wn])
    assert "GTA mode" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "logs" / "wavenet" / "ckpt" / "serving" / "1.npz")


def bridged_checkpoint(ckpt, extra=""):
    """One directory that holds the JAX (Orbax) checkpoint of a tiny
    Tacotron-2 (``TACO2`` + ``extra``) and the port's serving archive of
    the same weights, so that both packages export from it."""
    jcfg = j_load("taco2").parse(TACO2 + extra)
    tcfg = load_config("taco2").parse(TACO2 + extra)
    jcfg.num_speakers = tcfg.num_speakers = 1
    model = j_create("taco2", jcfg)
    tx, _ = j_make_optimizer(jcfg, "taco2")
    state = j_create_state(model, tx, jax.random.PRNGKey(0))
    mgr = JCheckpointManager(ckpt)
    mgr.save(3, state)
    mgr.wait()
    mgr.close()
    j_save_meta(ckpt, "taco2", jcfg, speaker_map={("ljspeech", "0"): 0})
    tp, ts = convert.tacotron_variables(
        create_model("taco2", tcfg),
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.bn_state))
    save_serving_checkpoint(ckpt, 3, "taco2", tcfg, tp, ts,
                            speaker_map={("ljspeech", "0"): 0})


def test_export_matches_jax_export(corpus, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    bridged_checkpoint(ckpt)
    kw = dict(batch_size=3, text_bucket=16, frame_bucket=32, **QUIET)
    jm = j_export(ckpt, {"ljspeech": corpus}, str(tmp_path / "j"), **kw)
    tm = export_gta(ckpt, {"ljspeech": corpus}, str(tmp_path / "t"),
                    device="cpu", **kw)
    assert tm == jm and tm["count"] == 4
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for name in tm["files"].values():
        j = np.load(tmp_path / "j" / name)
        t = np.load(tmp_path / "t" / name)
        assert t.shape == j.shape and t.dtype == np.float32
        np.testing.assert_allclose(t, j, atol=GTA_TOL, rtol=0)


def test_export_bf16_checkpoint_matches_jax_export(corpus, tmp_path):
    """``cli.export_gta`` from a checkpoint whose hparams say
    ``compute_dtype=bfloat16``: float32 ``.npy`` mels (the bf16 forward's
    output upcast, as JAX's ``.astype(np.float32)``), within JAX's bf16
    bound (atol 0.05, rtol 0.05) of JAX's float32 export of the same
    weights, and at most ``BF16_GAP_FACTOR`` times JAX's own bf16
    export's largest gap to it (the two bf16 forwards round at other
    points: XLA keeps float32 inside its fusions; found: 0.66-1.16
    times)."""
    kw = dict(batch_size=3, text_bucket=16, frame_bucket=32, **QUIET)
    ckpt32, ckpt16 = str(tmp_path / "ckpt32"), str(tmp_path / "ckpt16")
    bridged_checkpoint(ckpt32)
    bridged_checkpoint(ckpt16, ",compute_dtype=bfloat16")
    j_export(ckpt32, {"ljspeech": corpus}, str(tmp_path / "j32"), **kw)
    jm = j_export(ckpt16, {"ljspeech": corpus}, str(tmp_path / "j16"), **kw)
    out = str(tmp_path / "t16")
    gta_cli.main(["--device", "cpu", "--checkpoint", ckpt16, "--ljspeech", corpus,
                  "--out-dir", out, "--batch-size", "3", "--text-bucket", "16",
                  "--frame-bucket", "32"])
    with open(os.path.join(out, "manifest.json")) as f:
        tm = json.load(f)
    assert tm["files"] == jm["files"] and tm["count"] == 4
    for name in tm["files"].values():
        ref = np.load(tmp_path / "j32" / name)
        j = np.load(tmp_path / "j16" / name)
        t = np.load(os.path.join(out, name))
        assert t.shape == ref.shape and t.dtype == np.float32
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, ref, atol=BF16_TOL, rtol=BF16_TOL)
        gap, jgap = np.abs(t - ref).max(), np.abs(j - ref).max()
        assert gap <= BF16_GAP_FACTOR * jgap, (name, gap, jgap)
