"""Models: Tacotron-1 and Tacotron-2 (inference) and the WaveNet vocoder.

``simple_wavenet`` is a preset of the one WaveNet class, as in the JAX
package's registry."""

from nspeech_tpu_torch.models.tacotron import Tacotron1  # noqa: F401
from nspeech_tpu_torch.models.tacotron2 import Tacotron2  # noqa: F401
from nspeech_tpu_torch.models.wavenet import WaveNet  # noqa: F401

MODELS = {"taco1": Tacotron1, "taco2": Tacotron2, "wavenet": WaveNet,
          "simple_wavenet": WaveNet}


def check_ported(name: str) -> None:
    """Raise unless the port has model ``name``."""
    if name not in MODELS:
        raise ValueError(f"Unknown model: {name} (known: {sorted(MODELS)})")


def create_model(name: str, cfg):
    check_ported(name)
    return MODELS[name](cfg)
