"""nspeech_tpu_torch — the PyTorch / CUDA port of ``nspeech_tpu``.

Same module layout and names as the JAX package, so each module's
counterpart is found at the same path. Plain tensor code is PyTorch; the
one hand-written kernel (the WaveNet sampler, ``csrc/wavenet_gen.cu``) is
CUDA C++ for Hopper (sm_90a). The package imports neither ``jax`` nor
anything of ``nspeech_tpu``: what it needs from there it keeps as its own
copy.

Entry objects (``serving.Synthesizer``, ``serving.WaveNetVocoder``,
``serving.TextToSpeech``, and ``serving.StreamingTTS`` built on the first
two) run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from nspeech_tpu_torch.config import Config, load_config  # noqa: F401
