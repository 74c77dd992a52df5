"""The port's copies of the JAX package's host-side audio helpers (wav and
FLAC I/O, silence trimming, frame upsampling) against the originals, on
seeded inputs. They are numpy code copied as is, so the outputs must be
equal, bit for bit."""

import numpy as np
import pytest
from scipy.io import wavfile

from nspeech_tpu.data.wavenet_feeder import upsample_frames as j_upsample
from nspeech_tpu.dsp import trim as jtrim
from nspeech_tpu.dsp import wavio as jwavio
from nspeech_tpu_torch.data.wavenet_feeder import upsample_frames as t_upsample
from nspeech_tpu_torch.dsp import trim as ttrim
from nspeech_tpu_torch.dsp import wavio as twavio
from tests.make_flac import write_flac


def _speechlike(seed, n=40000):
    """Bursts of noise between stretches of near silence."""
    rng = np.random.default_rng(seed)
    env = np.repeat(rng.random(-(-n // 2000)) > 0.4, 2000)[:n]
    return (rng.standard_normal(n) * (0.3 * env + 0.002)).astype(np.float32)


@pytest.mark.parametrize("dtype,sr", [(np.int16, 20000), (np.int32, 16000),
                                      (np.uint8, 20000), (np.float32, 22050)])
def test_load_wav_matches(tmp_path, dtype, sr):
    wav = np.clip(_speechlike(1, 6000), -1, 1)
    if dtype == np.float32:
        data = wav
    elif dtype == np.uint8:
        data = (wav * 127 + 128).astype(np.uint8)
    else:
        data = (wav.astype(np.float64) * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "in.wav")
    wavfile.write(path, sr, np.stack([data, data[::-1]], axis=1))  # stereo
    j, t = jwavio.load_wav(path, 20000), twavio.load_wav(path, 20000)
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t, j)


def test_save_wav_and_stream_encoders_match(tmp_path):
    wav = _speechlike(2, 5000) * 3.0                   # peaks above full scale
    jwavio.save_wav(wav, str(tmp_path / "j.wav"), 20000)
    twavio.save_wav(wav, str(tmp_path / "t.wav"), 20000)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()
    np.testing.assert_array_equal(twavio.load_wav(str(tmp_path / "t.wav"), 20000),
                                  jwavio.load_wav(str(tmp_path / "j.wav"), 20000))
    assert twavio.encode_wav_bytes(wav, 20000) == jwavio.encode_wav_bytes(wav, 20000)
    assert twavio.encode_pcm16(wav) == jwavio.encode_pcm16(wav)
    assert twavio.wav_stream_header(20000) == jwavio.wav_stream_header(20000)


def test_load_flac_matches(tmp_path):
    rng = np.random.default_rng(3)
    samples = np.clip(rng.normal(0, 2000, (3000, 2)).cumsum(axis=0) * 0.02,
                      -32768, 32767).astype(np.int64)
    path = write_flac(str(tmp_path / "in.flac"), samples, 16000, kind="lpc",
                      lpc=([3, -1], 1, 5), stereo_mode="mid_side")
    j, t = jwavio.load_wav(path, 20000), twavio.load_wav(path, 20000)
    assert t.size == 3750
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [4, 5])
def test_trim_matches(seed):
    wav = np.concatenate([np.zeros(9000, np.float32), _speechlike(seed),
                          np.zeros(7000, np.float32)])
    for threshold in (0.01, 0.1):
        np.testing.assert_array_equal(ttrim.trim_silence(wav, threshold),
                                      jtrim.trim_silence(wav, threshold))
    assert ttrim.trim_silence(wav * 0, 0.1).size == 0
    np.testing.assert_array_equal(ttrim.split_nonsilent(wav),
                                  jtrim.split_nonsilent(wav))
    t = ttrim.trim_wav(wav)
    np.testing.assert_array_equal(t, jtrim.trim_wav(wav))
    assert 0 < t.size < wav.size


@pytest.mark.parametrize("frames,length", [(12, 3000), (7, 1000), (1, 64)])
def test_upsample_frames_matches(frames, length):
    mel = np.random.default_rng(frames).random((frames, 80)).astype(np.float32)
    t = t_upsample(mel, 250, length)
    np.testing.assert_array_equal(t, j_upsample(mel, 250, length))
    assert t.shape == (length, 80) and t.dtype == np.float32
