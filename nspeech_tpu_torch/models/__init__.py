"""Models: Tacotron-2 (inference) and the WaveNet vocoder."""

from nspeech_tpu_torch.models.tacotron2 import Tacotron2  # noqa: F401
from nspeech_tpu_torch.models.wavenet import WaveNet  # noqa: F401
