"""Serving: text -> (Tacotron-2) mel -> (WaveNet | Griffin-Lim) waveform."""

from nspeech_tpu_torch.serving.errors import ClientError  # noqa: F401
from nspeech_tpu_torch.serving.pipeline import TextToSpeech, WaveNetVocoder  # noqa: F401
from nspeech_tpu_torch.serving.synthesizer import Synthesizer  # noqa: F401
