"""Serving: text -> (Tacotron) mel -> (WaveNet | Griffin-Lim) waveform,
one-shot or streamed, one request at a time or batched."""

from nspeech_tpu_torch.serving.batcher import DynamicBatcher, StreamBatcher  # noqa: F401
from nspeech_tpu_torch.serving.errors import ClientError  # noqa: F401
from nspeech_tpu_torch.serving.longform import split_text, synthesize_long  # noqa: F401
from nspeech_tpu_torch.serving.pipeline import TextToSpeech, WaveNetVocoder  # noqa: F401
from nspeech_tpu_torch.serving.streaming import StreamingTTS  # noqa: F401
from nspeech_tpu_torch.serving.synthesizer import Synthesizer  # noqa: F401
