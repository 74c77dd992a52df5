"""``python -m nspeech_tpu_torch.cli.preprocess`` against the JAX
package's ``preprocess.py`` on a tiny LJSpeech-layout corpus written at
22,050 Hz (resampled to the hparams' 20,000 Hz), on the CPU: the same
cache file names (the JAX package's key), the same summary line, and the
cached arrays within 1e-6 (waveform) and 1.5e-5 (mel); the linear
spectrogram within 1.5e-5 but for bins far below their frame's peak,
which carry the FFT libraries' rounding and are bounded by the
featurizer's 2e-4 (``tests/test_torch_train_data.py``). Each package reads
the cache the other wrote.
"""

import os
import sys

import numpy as np
import pytest
import torch

from nspeech_tpu_torch.cli import preprocess as t_pre
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.data.features import process_utterance

from tests.make_synth_corpus import make_corpus

torch.set_num_threads(1)

LINEAR_TOL = 2e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("corpus22k")), n=4,
                       sample_rate=22050)


def _run_jax(corpus, cache, monkeypatch):
    import preprocess as j_pre

    monkeypatch.setattr(sys, "argv", [
        "preprocess.py", "--ljspeech", corpus, "--model", "taco2",
        "--cache-dir", cache, "--platform", "cpu"])
    j_pre.main()


def _summary(out: str) -> str:
    done = [line for line in out.splitlines() if line.startswith("Done:")][0]
    return done.rsplit(" in ", 1)[0]   # drop the wall time


def test_cache_matches_jax_preprocess(corpus, tmp_path, monkeypatch, capsys):
    jcache, tcache = str(tmp_path / "jax"), str(tmp_path / "port")
    _run_jax(corpus, jcache, monkeypatch)
    jout = capsys.readouterr().out
    t_pre.main(["--ljspeech", corpus, "--model", "taco2",
                "--cache-dir", tcache])
    tout = capsys.readouterr().out
    assert "Processing 4 utterances -> %s" % tcache in tout
    assert _summary(tout) == _summary(jout)
    names = sorted(os.listdir(tcache))
    assert names == sorted(os.listdir(jcache)) and len(names) == 4
    for name in names:
        with np.load(os.path.join(tcache, name)) as t, \
                np.load(os.path.join(jcache, name)) as j:
            assert t["wav"].shape == j["wav"].shape
            np.testing.assert_allclose(t["wav"], j["wav"], atol=1e-6, rtol=0)
            np.testing.assert_allclose(t["mel"], j["mel"], atol=1.5e-5, rtol=0)
            gap = np.abs(t["linear"] - j["linear"])
            assert gap.max() <= LINEAR_TOL
            assert np.mean(gap > 1.5e-5) < 1e-3


def test_workers_limit_and_cache_reuse(corpus, tmp_path, capsys):
    """Two worker processes and --limit; the port then reads the JAX
    cache layout it wrote without featurizing again."""
    cache = str(tmp_path / "cache")
    t_pre.main(["--ljspeech", corpus, "--model", "taco2", "--cache-dir",
                cache, "--num-workers", "2", "--limit", "3"])
    assert "Done: 3 utterances" in capsys.readouterr().out
    assert len(os.listdir(cache)) == 3
    path = os.path.join(corpus, "wavs", "SYN000.wav")
    cfg = load_config("taco2")
    cached = process_utterance(path, cfg, cache)
    fresh = process_utterance(path, cfg)
    np.testing.assert_array_equal(cached.mel, fresh.mel)
