"""The port's data path for training against the JAX package's, on the CPU:
mel filterbank, featurizer, per-utterance features and their cache, corpus
loaders, CMUDict and the data feeder, on the synthetic corpus.

Tolerances:
- ``mel_filterbank``: within 1e-7 (the same float64 numpy, cast to float32).
- Spectrograms: mel within 1e-5 absolute (found: 2.6e-6); linear within
  2e-4 absolute (found: 7.5e-5; ``scripts/torch_train_parity_report.py``).
  Both packages take float32 FFTs of 2,048 points with different
  libraries (XLA's and PyTorch's), and a bin far below its frame's peak
  carries the FFT's rounding, ~1e-7 of the peak, as a large relative
  error that the dB scale turns into up to ~1e-4 of the [0, 1] range;
  against a float64 FFT the JAX package's own linear spectrogram is off
  by up to 4.9e-5 and the port's by 7.7e-5. The mel sums many bins and
  does not show it.
- The feeder: identical inputs, lengths, speaker ids, padded shapes and
  batch order over 2 epochs (holdout split, tiny-corpus wrap-around and
  CMUDict substitution included); targets within the spectrogram
  tolerances above.
"""

import os
import threading

import numpy as np
import pytest
import torch

from nspeech_tpu import dsp as jdsp
from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.data import corpus as jcorpus
from nspeech_tpu.data.features import process_utterance as j_process
from nspeech_tpu.data.feeder import DataFeeder as JFeeder
from nspeech_tpu.dsp.mel import mel_filterbank as j_mel_filterbank
from nspeech_tpu.text.cmudict import CMUDict as JCMUDict
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.data import corpus as tcorpus
from nspeech_tpu_torch.data.features import build_from_paths
from nspeech_tpu_torch.data.features import process_utterance as t_process
from nspeech_tpu_torch.data.feeder import DataFeeder as TFeeder
from nspeech_tpu_torch.dsp import audio as taudio
from nspeech_tpu_torch.dsp.mel import mel_filterbank as t_mel_filterbank
from nspeech_tpu_torch.dsp.wavio import load_wav
from nspeech_tpu_torch.text.cmudict import CMUDict as TCMUDict
from nspeech_tpu_torch.text.symbols import symbols

from tests.make_synth_corpus import make_corpus

torch.set_num_threads(1)

LINEAR_TOL = 2e-4
MEL_TOL = 1e-5
CMUDICT = ("THE  DH AH0\nBIRCH  B ER1 CH\nCANOE  K AH0 N UW1\n"
           "GLUE  G L UW1\nGLUE(1)  G L UW2\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("corpus")), n=6)


@pytest.fixture(scope="module")
def wav_paths(corpus):
    return [it[0] for it in tcorpus.load_items({"ljspeech": corpus})]


def configs(extra=""):
    return j_load("taco2").parse(extra), t_load("taco2").parse(extra)


def assert_features(t_lin, t_mel, j_lin, j_mel):
    assert t_lin.shape == np.shape(j_lin) and t_mel.shape == np.shape(j_mel)
    np.testing.assert_allclose(t_lin, np.asarray(j_lin), atol=LINEAR_TOL, rtol=0)
    np.testing.assert_allclose(t_mel, np.asarray(j_mel), atol=MEL_TOL, rtol=0)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (20000, 2048, 80, 0.0, None), (16000, 1024, 40, 0.0, None),
    (22050, 2048, 80, 125.0, 7600.0)])
def test_mel_filterbank_matches(sr, n_fft, n_mels, fmin, fmax):
    t = t_mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    j = j_mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert t.dtype == np.float32 and t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=1e-7, rtol=0)


@pytest.mark.parametrize("which", ["corpus", "shorter_than_half_fft", "noise"])
def test_spectrograms_match(wav_paths, which):
    jc, tc = configs()
    if which == "corpus":
        wavs = [taudio_load(p) for p in wav_paths]
    elif which == "shorter_than_half_fft":   # the constant-pad case
        wavs = [np.random.default_rng(1).uniform(-0.5, 0.5, 700).astype(np.float32)]
    else:
        wavs = [0.1 * np.random.default_rng(2).standard_normal(7777).astype(np.float32)]
    for wav in wavs:
        t_lin, t_mel = taudio.spectrograms(wav, tc)
        j_lin, j_mel = jdsp.spectrograms(wav, jc)
        assert_features(t_lin, t_mel, j_lin, j_mel)
        assert t_lin.shape[0] == taudio.num_frames(len(wav), 2048, 250)
        np.testing.assert_array_equal(taudio.spectrogram(wav, tc), t_lin)
        np.testing.assert_array_equal(taudio.melspectrogram(wav, tc), t_mel)


def taudio_load(path):
    return load_wav(path, 20000)


def test_process_utterance_and_caches_match(wav_paths, tmp_path):
    jc, tc = configs()
    for p in wav_paths[:3]:
        j = j_process(p, jc)
        t = t_process(p, tc)
        assert t.utt_id == j.utt_id and t.n_frames == j.n_frames
        np.testing.assert_array_equal(t.wav, j.wav)
        assert_features(t.linear, t.mel, j.linear, j.mel)
    # a cache written by one package reads the same in the other
    for writer, reader in ((j_process, t_process), (t_process, j_process)):
        cache = str(tmp_path / writer.__module__.split(".")[0])
        written = writer(wav_paths[0], jc if writer is j_process else tc, cache)
        assert len(os.listdir(cache)) == 1
        read = reader(wav_paths[0], tc if reader is t_process else jc, cache)
        for k in ("wav", "linear", "mel"):
            np.testing.assert_array_equal(getattr(read, k), getattr(written, k))


def test_build_from_paths_in_spawned_workers(wav_paths, tmp_path):
    _, tc = configs()
    serial = build_from_paths(wav_paths[:3], tc)
    parallel = build_from_paths(wav_paths[:3], tc, str(tmp_path), num_workers=2)
    assert len(os.listdir(tmp_path)) == 3
    for a, b in zip(serial, parallel):
        np.testing.assert_array_equal(a.linear, b.linear)
        np.testing.assert_array_equal(a.mel, b.mel)


def test_cmudict_matches(tmp_path):
    path = tmp_path / "cmudict.txt"
    path.write_text(";;; comment\n" + CMUDICT + "BAD  XX1\n", encoding="latin-1")
    for ambiguous in (True, False):
        j, t = JCMUDict(str(path), ambiguous), TCMUDict(str(path), ambiguous)
        assert len(t) == len(j)
        for word in ("the", "Birch", "canoe", "glue", "bad", "nothing"):
            assert t.lookup(word) == j.lookup(word)


def test_corpus_loaders_match(corpus, tmp_path):
    """VCTK, LibriSpeech-style and Arctic layouts built over the synthetic
    wavs: the same items and speaker map in both packages."""
    wavs = sorted(os.listdir(os.path.join(corpus, "wavs")))
    src = [os.path.join(corpus, "wavs", w) for w in wavs]
    vctk = tmp_path / "vctk"
    for i, s in enumerate(src[:4]):
        spk = "p%03d" % (225 + i % 2)
        (vctk / "wav48" / spk).mkdir(parents=True, exist_ok=True)
        (vctk / "txt" / spk).mkdir(parents=True, exist_ok=True)
        os.symlink(s, vctk / "wav48" / spk / f"{spk}_{i:03d}.wav")
        (vctk / "txt" / spk / f"{spk}_{i:03d}.txt").write_text(f"text {i}\n")
    libri = tmp_path / "libri"
    libri.mkdir()
    (libri / "corpus.csv").write_text("".join(
        f"{19 + i % 2}-198-{i:04d},{os.path.relpath(s, libri)},words {i},train\n"
        for i, s in enumerate(src[:3])))
    arctic = tmp_path / "arctic" / "cmu_us_bdl_arctic"
    (arctic / "wav").mkdir(parents=True)
    (arctic / "etc").mkdir()
    lines = []
    for i, s in enumerate(src[:2]):
        os.symlink(s, arctic / "wav" / f"arctic_a{i:04d}.wav")
        lines.append(f'( arctic_a{i:04d} "Arctic prompt {i}." )')
    (arctic / "etc" / "txt.done.data").write_text("\n".join(lines) + "\n")
    paths = {"ljspeech": corpus, "vctk": str(vctk), "librispeech": str(libri),
             "arctic": str(tmp_path / "arctic")}
    j_items, t_items = jcorpus.load_items(paths), tcorpus.load_items(paths)
    assert t_items == j_items and len(t_items) == 6 + 4 + 3 + 2
    assert tcorpus.build_speaker_map(t_items) == jcorpus.build_speaker_map(j_items)
    with pytest.raises(ValueError, match="Unknown corpus"):
        tcorpus.load_items({"timit": corpus})


@pytest.mark.parametrize("hp,holdout", [
    ("batch_size=2,batch_group_size=2", 1),
    ("batch_size=7,batch_group_size=1", 1),   # 5 items < 7: wrap-around
])
def test_feeder_batches_match_over_two_epochs(corpus, tmp_path, hp, holdout):
    jc, tc = configs(hp)
    dict_path = tmp_path / "cmudict.txt"
    dict_path.write_text(CMUDICT, encoding="latin-1")
    jf = JFeeder({"ljspeech": corpus}, jc, seed=3, holdout=holdout,
                 cmudict=JCMUDict(str(dict_path), keep_ambiguous=False))
    tf = TFeeder({"ljspeech": corpus}, tc, seed=3, holdout=holdout,
                 cmudict=TCMUDict(str(dict_path), keep_ambiguous=False))
    assert tf.speaker2id == jf.speaker2id
    assert tf.holdout_items == jf.holdout_items and len(tf.holdout_items) == holdout
    substituted = False
    for epoch in (0, 1):
        jb, tb = list(jf.epoch_batches(epoch)), list(tf.epoch_batches(epoch))
        assert len(tb) == len(jb) > 0
        for j, t in zip(jb, tb):
            for k in ("inputs", "input_lengths", "speaker_ids"):
                np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
                assert getattr(t, k).dtype == getattr(j, k).dtype
            assert t.audio.shape == j.audio.shape
            np.testing.assert_array_equal(t.audio, j.audio)
            assert_features(t.linear_targets, t.mel_targets, j.linear_targets,
                            j.mel_targets)
            substituted |= bool((t.inputs >= symbols.index("@AA")).any())
    assert substituted
    jh, th = jf.holdout_batch(), tf.holdout_batch()
    np.testing.assert_array_equal(th.inputs, jh.inputs)
    assert_features(th.linear_targets, th.mel_targets, jh.linear_targets,
                    jh.mel_targets)


def test_prefetch_passes_errors_on_and_stops(corpus, tmp_path):
    """A missing wav raises in the consumer; closing the stream stops the
    producer thread."""
    _, tc = configs("batch_size=2,batch_group_size=1")
    items = tcorpus.load_items({"ljspeech": corpus})
    items[3] = (str(tmp_path / "missing.wav"),) + items[3][1:]
    stream = TFeeder(items, tc, seed=0).batches()
    with pytest.raises(FileNotFoundError):
        for _ in range(10):
            next(stream)
    stream = TFeeder({"ljspeech": corpus}, tc, seed=0).batches()
    assert next(stream).inputs.shape[0] == 2
    before = threading.active_count()
    stream.close()
    assert threading.active_count() == before - 1
