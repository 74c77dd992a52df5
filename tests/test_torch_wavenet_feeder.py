"""The port's WaveNet window feeder against the JAX package's, on the CPU,
over the synthetic corpus: one seed gives the same batches in the same
order, across an epoch boundary, in the frame-rate layout (rows + phase,
the default), the legacy per-sample layout, and GTA mode (exported mels
behind silence rows), single- and multi-speaker.

Audio windows, speaker ids and phases are equal. Mel rows computed by the
featurizer are within 1e-4 absolute, the featurizer's bound (its linear
spectrogram is held within 2e-4 in ``tests/test_torch_train_data.py``:
float32 FFTs of two libraries, whose rounding in bins far below their
frame's peak the dB scale magnifies); found here: 1.44e-5, on the
two-speaker corpus of words with gaps between them. GTA rows read from
the files are equal, and the silence rows before them within the same
1e-4.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.data.wavenet_feeder import WaveNetFeeder as JFeeder
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.data.corpus import load_items
from nspeech_tpu_torch.data.gta import fingerprint, gta_path
from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder as TFeeder
from nspeech_tpu_torch.dsp.trim import trim_silence
from nspeech_tpu_torch.dsp.wavio import load_wav

from tests.make_synth_corpus import make_corpus

torch.set_num_threads(1)

MEL_TOL = 1e-4
HP = "batch_size=3,sample_size=4000"
RF = 1026
N_BATCHES = 8       # the corpus makes ~5 batches per epoch
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return {"ljspeech": make_corpus(str(tmp_path_factory.mktemp("corpus")), n=5)}


@pytest.fixture(scope="module")
def vctk(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "mac", os.path.join(ROOT, "scripts", "make_alignment_corpus.py"))
    mac = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mac)
    out = str(tmp_path_factory.mktemp("vctk"))
    return {"vctk": mac.make_corpus(out, n=4, seed=5, style="words", speakers=2)}


def write_gta(corpus, gta_dir, seed=0):
    """Random exported mels of the right frame count for every utterance,
    and a manifest with the config's fingerprint."""
    cfg = t_load("wavenet")
    rng = np.random.default_rng(seed)
    os.makedirs(gta_dir, exist_ok=True)
    files = {}
    for wav_path, _t, _s, _d in load_items(corpus):
        wav = trim_silence(load_wav(wav_path, cfg.sample_rate), cfg.silence_threshold)
        mel = rng.random((1 + len(wav) // 250, cfg.num_mels), dtype=np.float32)
        np.save(gta_path(gta_dir, wav_path), mel)
        files[os.path.abspath(wav_path)] = os.path.basename(gta_path(gta_dir, wav_path))
    with open(os.path.join(gta_dir, "manifest.json"), "w") as f:
        json.dump({"fingerprint": fingerprint(cfg), "files": files, "model": "test",
                   "checkpoint": "none", "step": None, "count": len(files)}, f)
    return gta_dir


def assert_same_batches(corpus, frame_lc, gta_dir=None, seed=3):
    jf = JFeeder(corpus, RF, j_load("wavenet").parse(HP), seed=seed,
                 frame_lc=frame_lc, gta_dir=gta_dir)
    tf = TFeeder(corpus, RF, t_load("wavenet").parse(HP), seed=seed,
                 frame_lc=frame_lc, gta_dir=gta_dir)
    assert tf.speaker2id == jf.speaker2id and tf.window == jf.window
    assert tf.frames_per_window == jf.frames_per_window
    for j, t in zip(*(zip(range(N_BATCHES), f.batches()) for f in (jf, tf))):
        j, t = j[1], t[1]
        np.testing.assert_array_equal(t.audio, j.audio)
        np.testing.assert_array_equal(t.speaker_ids, j.speaker_ids)
        assert t.audio.dtype == np.float32 and t.speaker_ids.dtype == np.int32
        if frame_lc:
            np.testing.assert_array_equal(t.mel_phase, j.mel_phase)
        else:
            assert t.mel_phase is None and j.mel_phase is None
        assert t.mel.shape == j.mel.shape and t.mel.dtype == np.float32
        np.testing.assert_allclose(t.mel, j.mel, atol=MEL_TOL, rtol=0)
    return jf, tf


@pytest.mark.parametrize("frame_lc", [True, False])
def test_batches_match(corpus, frame_lc):
    assert_same_batches(corpus, frame_lc)


def test_multi_speaker_batches_match(vctk):
    _, tf = assert_same_batches(vctk, True, seed=1)
    assert tf.num_speakers == 2


@pytest.mark.parametrize("frame_lc", [True, False])
def test_gta_batches_match(corpus, tmp_path, frame_lc):
    gta = write_gta(corpus, str(tmp_path / "gta"))
    jf, tf = assert_same_batches(corpus, frame_lc, gta_dir=gta)
    assert tf._gta_pad == jf._gta_pad and tf._gta_pad % 250 == 0
    # the rows past the silence pad are the files' own, exactly
    b = next(tf.batches())
    pad_rows = tf._gta_pad // 250
    first = np.load(gta_path(gta, load_items(corpus)[
        int(np.random.default_rng((3, 0)).permutation(5)[0])][0]))
    if frame_lc:
        np.testing.assert_array_equal(b.mel[0, pad_rows:], first[: b.mel.shape[1] - pad_rows])
    np.testing.assert_allclose(b.mel[0, :1], tf._silence_row, atol=0)


def test_no_window_raises(corpus):
    cfg = t_load("wavenet").parse("batch_size=2,sample_size=100000")
    with pytest.raises(RuntimeError, match="longer than one window"):
        next(TFeeder(corpus, RF, cfg).batches())
