"""The port's trainers end to end on the CPU (tiny widths, the synthetic
corpus): ``python -m nspeech_tpu_torch.cli.train`` writes checkpoints that
resume and serve, also from batches held by ``--device-cache``; the
checkpoint manager's retention policy and EMA toggling, the explosion
guard, the holdout loss, the artifacts (-wav.png among them), the bf16
compute policy and ``--matmul-precision`` training, and the options whose
modules are not ported yet exiting with their ROADMAP item. ``python -m
nspeech_tpu_torch.cli.train_wavenet`` trains, resumes and writes a
checkpoint that ``cli.generate_wavenet --device cpu`` serves, with the
``config.json`` that the JAX package's ``train_wavenet.py`` writes for the
same corpus (the config after the start-up mutations and the speaker
map); ``--gta-dir`` without local conditioning exits. ``--git`` stamps the run
with the hash that the JAX package's helper reads, and refuses a dirty
tree as it does.
"""

import json
import os
import shutil
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from nspeech_tpu_torch.cli import generate_wavenet as gen_cli
from nspeech_tpu_torch.cli import synthesize as synth_cli
from nspeech_tpu_torch.cli import train as train_cli
from nspeech_tpu_torch.cli import train_wavenet as wn_cli
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.dsp.wavio import load_wav
from nspeech_tpu_torch.serving import Synthesizer
from nspeech_tpu_torch.train import load_serving_params
from nspeech_tpu_torch.train.checkpoint import CheckpointManager
from nspeech_tpu_torch.train.loop import TrainState
from nspeech_tpu_torch.train.runner import run_training
from nspeech_tpu_torch.utils.tree import tree_leaves

from tests.make_synth_corpus import make_corpus

torch.set_num_threads(1)

TINY = ("batch_size=2,batch_group_size=2,max_iters=6,griffin_lim_iters=3,"
        "encoder_conv_layers=2,postnet_conv_layers=2,expand_conv_layers=2,"
        "encoder_conv_channels=32,attention_dim=32,postnet_conv_channels=32,"
        "expand_conv_channels=32,decoder_lstm_units=32,encoder_lstm_units=16,"
        "expand_lstm_units=16,embedding_dim=32")
TINY_WN = ("batch_size=2,sample_size=512,dilations_length=4,dilations_depth=2,"
           "residual_channels=8,dilation_channels=8,skip_channels=16,"
           "quantization_channels=128,lc_channels=80,gc_channels=4")
TINY1 = ("batch_size=2,batch_group_size=2,max_iters=6,griffin_lim_iters=3,"
         "encoder_cbhg_banks=2,post_cbhg_banks=2,attention_dim=32,"
         "decoder_dim=32,embedding_dim=32")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("corpus")), n=6)


def train(corpus, log_dir, *extra, model="taco2", hparams=TINY):
    argv = ["--device", "cpu", "--ljspeech", corpus, "--log-dir", str(log_dir)]
    argv += ["--model", model] if model else []
    argv += ["--hparams", hparams] if hparams else []
    train_cli.main(argv + list(extra))


@pytest.fixture(scope="module")
def run(corpus, tmp_path_factory):
    """3 steps, checkpoints every 2, summaries every step, one held-out
    utterance; returns the run directory."""
    log_dir = tmp_path_factory.mktemp("logs")
    train(corpus, log_dir, "--max-steps", "3", "--checkpoint-interval", "2",
          "--summary-interval", "1", "--holdout", "1")
    return os.path.join(str(log_dir), "taco2")


def test_first_run_writes_checkpoints_metrics_and_artifacts(run):
    ckpt = os.path.join(run, "ckpt")
    assert sorted(os.listdir(os.path.join(ckpt, "train"))) == ["2.pt", "3.pt"]
    assert sorted(os.listdir(os.path.join(ckpt, "serving"))) == ["2.npz", "3.npz"]
    meta = json.load(open(os.path.join(ckpt, "config.json")))
    assert meta["model"] == "taco2" and meta["speaker_map"] == [["ljspeech", "0", 0]]
    assert meta["hparams"]["num_speakers"] == 1
    for suffix in ("audio.wav", "lin.png", "mel.png", "align.png", "wav.png"):
        assert os.path.getsize(os.path.join(run, "step-000002-" + suffix)) > 0
    with open(os.path.join(run, "step-000002-wav.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    recs = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    losses = [r for r in recs if "loss" in r]
    assert [r["step"] for r in losses] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["learning_rate"] > 0 for r in losses)
    holdout = [r for r in recs if "holdout_loss" in r]
    assert [r["step"] for r in holdout] == [1, 2, 3]
    assert all(np.isfinite(r["holdout_loss_mel"]) for r in holdout)
    assert any("grad_norms/max" in r for r in recs)
    assert "Step 3 " in open(os.path.join(run, "train.log")).read()


def test_serving_archive_loads_and_synthesizes(run, tmp_path):
    ckpt = os.path.join(run, "ckpt")
    syn = Synthesizer.from_checkpoint(ckpt, device="cpu")
    state = torch.load(os.path.join(ckpt, "train", "3.pt"), weights_only=True)
    params, _ = load_serving_params(ckpt, syn.model, step=3)
    for a, b in zip(tree_leaves(params), tree_leaves(state["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    out = str(tmp_path / "s.wav")
    synth_cli.main(["--device", "cpu", "--checkpoint", ckpt, "--text",
                    "Hello there.", "--out", out])
    assert load_wav(out, 20000).size > 0


def test_second_run_resumes_and_restore_step(corpus, run, tmp_path, capsys):
    log_dir = tmp_path / "logs"
    shutil.copytree(os.path.dirname(run), log_dir)
    capsys.readouterr()
    train(corpus, log_dir, "--max-steps", "4", "--checkpoint-interval", "2")
    out = capsys.readouterr().out
    assert "Resumed from checkpoint step 3" in out and "Step 4 " in out
    ckpt = log_dir / "taco2" / "ckpt"
    assert sorted(os.listdir(ckpt / "train")) == ["2.pt", "3.pt", "4.pt"]
    # the resumed run's serving archive serves through the synthesize CLI
    out = str(tmp_path / "resumed.wav")
    synth_cli.main(["--device", "cpu", "--checkpoint", str(ckpt), "--text",
                    "Resumed.", "--out", out])
    assert "Wrote" in capsys.readouterr().out and load_wav(out, 20000).size > 0
    train(corpus, log_dir, "--max-steps", "3", "--checkpoint-interval", "2",
          "--restore-step", "2")
    out = capsys.readouterr().out
    assert "Resumed from checkpoint step 2" in out and "Step 3 " in out
    # --hparams-from takes the model and hparams from the run's metadata
    train(corpus, tmp_path / "ft", "--max-steps", "1", "--hparams-from",
          str(ckpt), model=None, hparams="")
    meta = json.load(open(tmp_path / "ft" / "taco2" / "ckpt" / "config.json"))
    assert meta["model"] == "taco2"
    assert meta["hparams"]["decoder_lstm_units"] == 32


def test_taco1_trains_and_serves(corpus, tmp_path):
    train(corpus, tmp_path, "--max-steps", "2", "--checkpoint-interval", "2",
          model="taco1", hparams=TINY1)
    ckpt = str(tmp_path / "taco1" / "ckpt")
    syn = Synthesizer.from_checkpoint(ckpt, device="cpu")
    wav, mel, _ = syn.synthesize("Two steps in.")
    assert wav.size > 0 and np.isfinite(mel).all()


def tiny_state(value=1.0, ema=False):
    params = {"w": torch.full((3,), value), "layers": [{"b": torch.zeros(2)}]}
    opt = {"count": 0, "mu": {"w": torch.zeros(3)}, "nu": {"w": torch.zeros(3)}}
    return TrainState(0, params, {"bn": {"mean": torch.zeros(2)}}, opt,
                      {"w": torch.full((3,), 9.0), "layers": [{"b": torch.ones(2)}]}
                      if ema else None)


def manager(path, **kw):
    return CheckpointManager(str(path), "taco2", load_config("taco2"), **kw)


def test_retention_keeps_newest_five_and_one_per_period(tmp_path):
    mgr = manager(tmp_path)
    base = 1_000_000.0
    for step in range(1, 11):   # one save every 50 minutes
        mgr.save(step, tiny_state())
        t = base + (step - 1) * 3000.0
        os.utime(tmp_path / "train" / f"{step}.pt", (t, t))
    # newest 5 (6-10), the oldest (1), and 4, 2.5 h after 1; 7 is among
    # the newest 5 anyway
    assert mgr.all_steps() == [1, 4, 6, 7, 8, 9, 10]
    assert sorted(int(f[:-4]) for f in os.listdir(tmp_path / "serving")) \
        == [1, 4, 6, 7, 8, 9, 10]
    assert mgr.latest_step() == 10


def test_ema_toggles_across_restore(tmp_path):
    mgr = manager(tmp_path / "a")
    mgr.save(5, tiny_state(ema=True))
    # serving archive: the EMA params
    served = np.load(tmp_path / "a" / "serving" / "5.npz")
    np.testing.assert_array_equal(served["params/w"], np.full(3, 9.0))
    restored = mgr.restore(tiny_state(ema=False))
    assert restored.ema_params is None and restored.step == 5
    mgr = manager(tmp_path / "b")
    mgr.save(7, tiny_state(value=2.0))
    restored = mgr.restore(tiny_state(ema=True))
    torch.testing.assert_close(restored.ema_params["w"], torch.full((3,), 2.0))
    assert restored.ema_params["w"].data_ptr() != restored.params["w"].data_ptr()
    bad = tiny_state()._replace(params={"w": torch.zeros(4),
                                        "layers": [{"b": torch.zeros(2)}]})
    with pytest.raises(ValueError, match="params does not match"):
        mgr.restore(bad)
    with pytest.raises(FileNotFoundError):
        mgr.restore(tiny_state(), step=3)


class FakeBatch(NamedTuple):
    inputs: np.ndarray
    input_lengths: np.ndarray
    speaker_ids: np.ndarray
    mel_targets: np.ndarray
    linear_targets: np.ndarray


def fake_batches():
    b = FakeBatch(np.ones((1, 2), np.int32), np.array([2], np.int32),
                  np.zeros(1, np.int32), np.zeros((1, 5, 2), np.float32),
                  np.zeros((1, 5, 3), np.float32))
    while True:
        yield b


def test_explosion_guard_restores_then_gives_up(tmp_path, capsys):
    exploded = []

    def step_fn(state, batch, generator):
        step = state.step + 1
        loss = 1.0
        if step == 3 and not exploded:
            exploded.append(step)
            loss = float("nan")
        params = {"w": state.params["w"] + 1.0,
                  "layers": state.params["layers"]}
        return (state._replace(step=step, params=params),
                {"loss": torch.tensor(loss)})

    mgr = manager(tmp_path / "a")
    final = run_training(str(tmp_path / "a"), mgr, tiny_state(), step_fn,
                         fake_batches(), torch.device("cpu"), 0,
                         checkpoint_interval=2, summary_interval=100,
                         max_steps=6, to_device=lambda b, device: b)
    out = capsys.readouterr().out
    assert "Loss exploded to nan at step 3" in out
    assert "Auto-restored from checkpoint step 2 (recovery 1/3)" in out
    assert final.step == 6
    torch.testing.assert_close(final.params["w"], torch.full((3,), 7.0))

    def always_nan(state, batch, generator):
        return (state._replace(step=state.step + 1),
                {"loss": torch.tensor(float("nan"))})

    mgr = manager(tmp_path / "b")
    mgr.save(0, tiny_state())
    with pytest.raises(RuntimeError, match="Loss exploded"):
        run_training(str(tmp_path / "b"), mgr, tiny_state(), always_nan,
                     fake_batches(), torch.device("cpu"), 0, max_steps=10,
                     to_device=lambda b, device: b)
    assert "recovery 3/3" in capsys.readouterr().out


@pytest.mark.parametrize("extra,hparams", [
    (["--matmul-precision", "bfloat16"], TINY),
    ([], TINY + ",compute_dtype=bfloat16"),
], ids=["matmul-precision-bfloat16", "compute-dtype-bfloat16"])
def test_reduced_precision_options_train(corpus, tmp_path, capsys, extra,
                                         hparams):
    """The two options that exited before the bf16 policy was ported
    train: the checkpoint's masters stay float32, the loss is finite, and
    the log names the precision and the compute dtype."""
    train(corpus, tmp_path, "--max-steps", "2", "--checkpoint-interval", "2",
          "--summary-interval", "1", *extra, hparams=hparams)
    out = capsys.readouterr().out
    dtype = "bfloat16" if "compute_dtype" in hparams else "float32"
    assert f"compute dtype {dtype}" in out
    assert "matmul precision: %s" % (extra[1] if extra else "highest") in out
    ckpt = tmp_path / "taco2" / "ckpt"
    state = torch.load(ckpt / "train" / "2.pt", weights_only=True)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["params"]))
    recs = [json.loads(line) for line in open(tmp_path / "taco2" / "metrics.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    syn = Synthesizer.from_checkpoint(str(ckpt), device="cpu")
    wav, mel, _ = syn.synthesize("Two steps in.")
    assert wav.size > 0 and mel.dtype == np.float32 and np.isfinite(mel).all()


@pytest.mark.parametrize("extra,env,match", [
    (["--model", "wavenet"], None, "nspeech_tpu_torch.cli.train_wavenet"),
    ([], "2", "item 5"),
])
def test_unported_options_exit_with_their_roadmap_item(corpus, tmp_path,
                                                       monkeypatch, extra, env,
                                                       match):
    if env is not None:
        monkeypatch.setenv("WORLD_SIZE", env)
    argv = ["--device", "cpu", "--ljspeech", corpus, "--log-dir", str(tmp_path),
            "--model", "taco2"] + extra
    with pytest.raises(SystemExit, match=match) as e:
        train_cli.main(argv)
    assert "ROADMAP.md" in str(e.value) or "train_wavenet" in match
    assert not os.path.exists(tmp_path / "taco2" / "ckpt")


def test_cuda_without_a_card_exits(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_cli.main(["--ljspeech", corpus, "--log-dir", str(tmp_path),
                        "--model", "taco2"])


def test_device_cache_trains(corpus, tmp_path, capsys):
    train(corpus, tmp_path, "--max-steps", "2", "--checkpoint-interval", "2",
          "--device-cache", "1")
    out = capsys.readouterr().out
    assert "Device-cached 3 batches" in out and "Step 2 " in out
    assert os.path.exists(tmp_path / "taco2" / "ckpt" / "serving" / "2.npz")
    assert os.path.getsize(tmp_path / "taco2" / "step-000002-align.png") > 0


def train_wavenet(corpus, log_dir, *extra, hparams=TINY_WN):
    wn_cli.main(["--device", "cpu", "--ljspeech", corpus, "--log-dir",
                 str(log_dir), "--hparams", hparams] + list(extra))


def test_wavenet_trains_resumes_and_serves(corpus, tmp_path, capsys):
    train_wavenet(corpus, tmp_path, "--max-steps", "2", "--checkpoint-interval",
                  "2", "--summary-interval", "1")
    run = tmp_path / "wavenet"
    recs = [json.loads(line) for line in open(run / "metrics.jsonl")]
    losses = [r for r in recs if "loss" in r]
    assert [r["step"] for r in losses] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["learning_rate"] > 0 for r in losses)
    assert any("grad_norms/max" in r for r in recs)
    assert not any("mel_targets/mean" in r for r in recs)   # no Tacotron targets
    train_wavenet(corpus, tmp_path, "--max-steps", "3", "--checkpoint-interval", "2")
    out = capsys.readouterr().out
    assert "Resumed from checkpoint step 2" in out and "Step 3 " in out
    ckpt = run / "ckpt"
    assert sorted(os.listdir(ckpt / "train")) == ["2.pt", "3.pt"]
    mel = np.random.default_rng(0).random((9, 80), dtype=np.float32)
    np.save(tmp_path / "mel.npy", mel)
    wav = tmp_path / "gen" / "out.wav"
    os.makedirs(wav.parent)
    gen_cli.main([str(ckpt), "--device", "cpu", "--samples", "300",
                  "--mel-npy", str(tmp_path / "mel.npy"), "--gc-id", "0",
                  "--wav_out_path", str(wav)])
    assert load_wav(str(wav), 20000).size == 300
    # the JAX CLI's audio summary opens metrics.jsonl beside the wav
    assert os.path.exists(wav.parent / "metrics.jsonl")


def test_wavenet_config_matches_jax_trainer(corpus, tmp_path, monkeypatch):
    import jax

    import train_wavenet as jax_wn

    monkeypatch.setattr(jax_wn, "run_training", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [
        "train_wavenet.py", "--platform", "cpu", "--ljspeech", corpus,
        "--log-dir", str(tmp_path / "jax"), "--hparams", TINY_WN,
        "--matmul-precision", "highest"])
    before = jax.config.jax_default_matmul_precision
    try:
        jax_wn.main()     # writes config.json, then (patched) trains nothing
    finally:
        jax.config.update("jax_default_matmul_precision", before)
    train_wavenet(corpus, tmp_path / "port", "--max-steps", "1")
    read = lambda d: json.load(open(tmp_path / d / "wavenet" / "ckpt" / "config.json"))
    port, ref = read("port"), read("jax")
    assert port == ref
    assert port["hparams"]["gc_category_cardinality"] == 1
    assert port["speaker_map"] == [["ljspeech", "0", 0]]


def test_gta_dir_needs_local_conditioning(corpus, tmp_path):
    with pytest.raises(SystemExit, match="lc_channels > 0"):
        train_wavenet(corpus, tmp_path, "--gta-dir", str(tmp_path),
                      hparams=TINY_WN.replace("lc_channels=80", "lc_channels=0"))


def git(repo, *args):
    return subprocess.run(["git", "-C", str(repo), "-c", "user.name=t",
                           "-c", "user.email=t@t", *args], check=True,
                          capture_output=True, text=True).stdout.strip()


@pytest.mark.parametrize("dirty", [False, True])
def test_git_stamp_matches_jax_helper(corpus, tmp_path, monkeypatch, dirty):
    from nspeech_tpu.utils import get_git_commit as jax_git_commit
    from nspeech_tpu_torch.utils import get_git_commit

    repo = tmp_path / "repo"
    repo.mkdir()
    git(repo, "init", "-q")
    (repo / "a.txt").write_text("one\n")
    git(repo, "add", "a.txt")
    git(repo, "commit", "-q", "-m", "first")
    if dirty:
        (repo / "a.txt").write_text("two\n")
    monkeypatch.chdir(repo)
    log_dir = tmp_path / "logs"
    if dirty:
        with pytest.raises(RuntimeError) as want:
            jax_git_commit()
        with pytest.raises(RuntimeError) as got:
            get_git_commit()
        assert str(got.value) == str(want.value)
        with pytest.raises(RuntimeError, match="uncommitted changes"):
            train(corpus, log_dir, "--git", "--max-steps", "1")
        assert not os.path.exists(log_dir / "taco2" / "ckpt")
        return
    head = git(repo, "rev-parse", "--short=10", "HEAD")
    assert get_git_commit() == jax_git_commit() == head
    train(corpus, log_dir, "--git", "--max-steps", "1")
    with open(log_dir / "taco2" / "train.log") as f:
        assert f"git commit: {head}" in f.read()
