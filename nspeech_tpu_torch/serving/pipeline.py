"""End-to-end text -> waveform: Tacotron (1 or 2) mels -> WaveNet vocoder.

Port of ``nspeech_tpu/serving/pipeline.py``. The frame-rate mel goes to the
device and is upsampled there; the sampler is the CUDA kernel on a CUDA
device (a failure raises, there is no fallback) and the plain PyTorch
generator on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nspeech_tpu_torch.config import Config, stft_params
from nspeech_tpu_torch import dsp
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
from nspeech_tpu_torch.ops.layers import tree_to
from nspeech_tpu_torch.ops.upsample import upsample_on_device
from nspeech_tpu_torch.serving.errors import ClientError, check_ids
from nspeech_tpu_torch.serving.synthesizer import Synthesizer
from nspeech_tpu_torch.train import config_from_checkpoint, load_serving_params


class WaveNetVocoder:
    """Mel spectrogram [T, M] -> waveform via mel-conditioned WaveNet."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.net = None
        self._params = None
        self._gen = None
        self._gen_gc = None  # gc_ids the cached generator was packed with
        _, self._hop, _ = stft_params(cfg)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        model_name: Optional[str] = None,
                        overrides: str = "", step: Optional[int] = None,
                        device="cuda") -> "WaveNetVocoder":
        """Build a vocoder from the checkpoint's run metadata (exact
        training-time hparams incl. lc/gc channels and the mutated
        gc_category_cardinality), with ``k=v,...`` overrides applied
        last."""
        cfg, name = config_from_checkpoint(checkpoint_dir, model_name,
                                           overrides, default_model="wavenet")
        return cls(cfg, device=device).load(checkpoint_dir, name, step=step)

    def load(self, checkpoint_dir: str, model_name: str = "wavenet",
             step: Optional[int] = None) -> "WaveNetVocoder":
        """Restore the serving parameters of ``serving/<step>.npz`` (the
        latest step by default)."""
        net = create_model(model_name, self.cfg)
        params, _ = load_serving_params(checkpoint_dir, net, step=step,
                                        device=self.device)
        return self.set_variables(net, params)

    def set_variables(self, net, params) -> "WaveNetVocoder":
        self.net = net
        self._params = tree_to(params, self.device)
        self._gen = None
        return self

    def vocode(self, mel: np.ndarray, speaker_id: Optional[int] = None,
               temperature: float = 1.0, seed: int = 0) -> np.ndarray:
        """mel: [T_frames, M] normalized mel -> float waveform."""
        wavs = self.vocode_batch(
            np.asarray(mel)[None],
            None if speaker_id is None else [speaker_id],
            temperature=temperature, seed=seed)
        return wavs[0]

    @torch.no_grad()
    def vocode_batch(self, mels: np.ndarray, speaker_ids=None,
                     temperature: float = 1.0, seed: int = 0) -> np.ndarray:
        """mels: [N, T_frames, M] (equal lengths) -> [N, T*hop] waveforms,
        all N streams in one sampler call.

        With speakers (``gc_channels`` > 0), an id outside [0,
        ``gc_category_cardinality``) raises :class:`ClientError` before
        anything is launched (JAX serves NaN rows there; on the card the
        index would be a device-side assert that leaves the CUDA context
        unusable)."""
        if self.net.lc_channels <= 0:
            raise ValueError(
                "Vocoder checkpoint was trained without local conditioning "
                "(lc_channels=0); it cannot follow a mel spectrogram.")
        gc_ids = None
        if speaker_ids is not None and self.net.gc_channels:
            gc_ids = [int(s) for s in speaker_ids]
            check_ids(gc_ids, self.net.gc_cardinality, "gc id")
        mels = np.asarray(mels, np.float32)
        n = mels.shape[0]
        n_samples = mels.shape[1] * self._hop
        lc = upsample_on_device(torch.from_numpy(mels).to(self.device),
                                self._hop, n_samples)      # [N, T*hop, M]
        # the generator folds the speakers into its packed biases
        gc_key = None if gc_ids is None else tuple(gc_ids)
        if self._gen is None or self._gen_gc != gc_key:
            self._gen = CudaWaveNetGenerator(self.net, self._params, gc_ids=gc_ids)
            self._gen_gc = gc_key
        codes = self._gen(n_samples, seed=seed, batch=n, lc=lc,
                          temperature=temperature)
        return dsp.mu_law_decode(codes, self.net.quantization_channels).cpu().numpy()


class TextToSpeech:
    """Full pipeline: text -> (Tacotron) mel -> (WaveNet | Griffin-Lim) wav."""

    def __init__(self, synthesizer: Synthesizer,
                 vocoder: Optional[WaveNetVocoder] = None):
        self.synthesizer = synthesizer
        self.vocoder = vocoder

    @property
    def cfg(self):
        return self.synthesizer.cfg

    def synthesize(self, text: str, speaker_id: int = -1,
                   temperature: float = 1.0, return_gl: bool = False,
                   want_features=True):
        """(wav, mel, lin), or (wav, mel, lin, wav_gl) with ``return_gl``.
        The Griffin-Lim waveform is computed either way: its endpoint
        trims the vocoder input."""
        wav_gl, mel, lin = self.synthesizer.synthesize(
            text, speaker_id, want_features=True if want_features else "mel")
        if self.vocoder is None:
            return (wav_gl, mel, lin, wav_gl) if return_gl else (wav_gl, mel, lin)
        # vocode only the frames that carry speech per the GL endpoint
        n_frames = int(np.ceil(len(wav_gl) / self.vocoder._hop))
        wav = self.vocoder.vocode(
            mel[: max(n_frames, 1)], speaker_id if speaker_id >= 0 else None,
            temperature=temperature)
        wav = wav[: dsp.find_endpoint(wav, self.synthesizer.cfg)]
        return (wav, mel, lin, wav_gl) if return_gl else (wav, mel, lin)

    def synthesize_batch(self, texts, speaker_ids=None, temperature: float = 1.0):
        """One padded acoustic forward and one batched vocoder call for N
        texts. Returns (wavs list, mels, linears)."""
        wavs_gl, mels, lins = self.synthesizer.synthesize_batch(texts, speaker_ids)
        if self.vocoder is None:
            return wavs_gl, mels, lins
        hop = self.vocoder._hop
        frames = [max(int(np.ceil(len(w) / hop)), 1) for w in wavs_gl]
        t_max = max(frames)
        # -1/None means unconditioned; one batched call packs one speaker
        # table, so conditioned and unconditioned streams cannot mix
        gc = None
        if speaker_ids is not None:
            missing = [s is None or s < 0 for s in speaker_ids]
            if any(missing) and not all(missing):
                raise ClientError(
                    "synthesize_batch: cannot mix explicit speaker_ids and "
                    "-1/None (unconditioned) in one vocoder batch")
            if not any(missing):
                gc = list(speaker_ids)
        batch_wavs = self.vocoder.vocode_batch(mels[:, :t_max], gc,
                                               temperature=temperature)
        out = []
        for i, w in enumerate(batch_wavs):
            w = w[: frames[i] * hop]
            out.append(w[: dsp.find_endpoint(w, self.synthesizer.cfg)])
        return out, mels, lins
