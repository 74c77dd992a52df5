"""DSP layer: waveform inversion and mu-law coding on tensors."""

from nspeech_tpu_torch.dsp.audio import (  # noqa: F401
    db_to_amp,
    denormalize,
    find_endpoint,
    inv_preemphasis,
    inv_spectrogram,
    istft,
    stft,
)
from nspeech_tpu_torch.dsp.mulaw import mu_law_decode, mu_law_encode  # noqa: F401
