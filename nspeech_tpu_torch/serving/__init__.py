"""Serving: text -> (Tacotron-2) mel -> (WaveNet | Griffin-Lim) waveform,
one-shot or streamed."""

from nspeech_tpu_torch.serving.errors import ClientError  # noqa: F401
from nspeech_tpu_torch.serving.pipeline import TextToSpeech, WaveNetVocoder  # noqa: F401
from nspeech_tpu_torch.serving.streaming import StreamingTTS  # noqa: F401
from nspeech_tpu_torch.serving.synthesizer import Synthesizer  # noqa: F401
