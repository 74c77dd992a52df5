"""Stop-threshold calibration in the port (``train/stopcal.py``,
``python -m nspeech_tpu_torch.cli.calibrate_stop``) against the JAX
package's (``nspeech_tpu/train/stopcal.py``, ``scripts/calibrate_stop.py``),
on the CPU.

- ``sliding_window_max``, ``stop_statistics`` and
  ``stop_statistics_from_decodes`` on seeded mels: equal to JAX's (the
  same numpy), also where the statistics refuse a threshold.
- The corpus mode's JSON on the synthetic corpus: the same keys, counts
  and ``r`` as the JAX script's, and its levels within 1.5e-5 (the mels
  the two featurizers compute differ by up to that much);
  ``--apply`` writes the threshold into a run's ``config.json``.
- The ``--run-dir`` mode decodes a checkpoint through the port's
  ``Synthesizer`` on the CPU and applies its recommendation.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from nspeech_tpu.train import stopcal as jstop
from nspeech_tpu_torch.cli import calibrate_stop as t_cli
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.train import loop as tloop
from nspeech_tpu_torch.train import stopcal as tstop
from nspeech_tpu_torch.train.checkpoint import CheckpointManager
from nspeech_tpu_torch.train.optim import make_optimizer

from tests.make_synth_corpus import make_corpus

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeded_mels(seed, n=12, quiet_tail=True):
    rng = np.random.default_rng(seed)
    mels = []
    for i in range(n):
        t = int(rng.integers(12, 60))
        mel = rng.uniform(0.3, 0.9, (t, 80)).astype(np.float32)
        if quiet_tail:
            mel[-6:] = rng.uniform(0.0, 0.05, (6, 80))
        mels.append(mel)
    return mels


def test_sliding_window_max_matches():
    x = np.random.default_rng(0).random(50).astype(np.float32)
    for w in (0, 1, 2, 5, 50):
        np.testing.assert_array_equal(tstop.sliding_window_max(x, w),
                                      jstop.sliding_window_max(x, w))


@pytest.mark.parametrize("seed,quiet_tail,r,tail", [
    (0, True, 2, 5), (1, True, 3, 4), (2, False, 2, 5)])
def test_stop_statistics_match(seed, quiet_tail, r, tail):
    mels = seeded_mels(seed, quiet_tail=quiet_tail) + [np.zeros((3, 80))]
    ours = tstop.stop_statistics(mels, r=r, tail=tail)
    ref = jstop.stop_statistics(mels, r=r, tail=tail)
    assert ours == ref
    assert (ours["threshold"] > 0) == quiet_tail


def test_stop_statistics_from_decodes_match():
    mels = seeded_mels(3, n=6)
    for mel in mels:
        mel[-30:] = 0.01
    bounds = [len(m) - 30 for m in mels]
    for guard in (0, 5, 20):
        assert (tstop.stop_statistics_from_decodes(mels, bounds, 2, guard)
                == jstop.stop_statistics_from_decodes(mels, bounds, 2, guard))
    assert tstop.stop_statistics_from_decodes([], [])["threshold"] == 0.0


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_calibrate_stop", os.path.join(ROOT, "scripts", "calibrate_stop.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(out: str) -> dict:
    return json.loads(out[out.index("{"): out.rindex("}") + 1])


def _run(tmp_path, model="taco2"):
    """A step-0 Tacotron checkpoint with its run metadata."""
    tiny = ("max_iters=12,encoder_conv_layers=1,postnet_conv_layers=1,"
            "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
            "postnet_conv_channels=16,expand_conv_channels=16,"
            "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
            "embedding_dim=16,griffin_lim_iters=2")
    cfg = load_config(model).parse(tiny)
    net = create_model(model, cfg)
    state = tloop.create_state(net, make_optimizer(cfg, model)[0], 0)
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt, model, cfg).save(1, state)
    return ckpt


def test_corpus_mode_matches_jax_script(tmp_path, capsys):
    corpus = make_corpus(str(tmp_path / "corpus"), n=6)
    argv = ["--ljspeech", corpus, "--hparams", "outputs_per_step=2",
            "--tail", "3"]
    assert _jax_script().main(argv + ["--platform", "cpu"]) == 0
    ref = _json(capsys.readouterr().out)
    ckpt = _run(tmp_path)
    assert t_cli.main(argv + ["--apply", ckpt]) == 0
    captured = capsys.readouterr()
    ours = _json(captured.out)
    assert set(ours) == set(ref)
    assert ours["r"] == ref["r"] == 2
    assert ours["n_utterances"] == ref["n_utterances"] == 6
    for k in ("threshold", "floor_p95", "danger_p05"):
        assert abs(ours[k] - ref[k]) <= 1.5e-5, k
    assert abs(ours["separation"] - ref["separation"]) <= 1e-4 * ref["separation"]
    assert "applied stop_threshold" in captured.err
    meta = json.load(open(os.path.join(ckpt, "config.json")))
    assert meta["hparams"]["stop_threshold"] == ours["threshold"]


def test_run_dir_mode_decodes_on_the_cpu(tmp_path, capsys):
    ckpt = _run(tmp_path)
    assert t_cli.main(["--run-dir", ckpt, "--device", "cpu", "--text",
                       "hello there.", "--text", "a b c.", "--apply", ckpt]) == 0
    out = capsys.readouterr().out
    stats = _json(out)
    assert stats["source"] == "decodes" and stats["r"] == 5   # taco2's r
    meta = json.load(open(os.path.join(ckpt, "config.json")))
    assert meta["hparams"]["stop_threshold"] == stats["threshold"]
    with pytest.raises(SystemExit):    # neither a corpus nor a run
        t_cli.main([])
