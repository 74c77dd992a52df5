"""Inference wrapper: text -> (waveform, mel, linear) with a Tacotron
(1 or 2) and Griffin-Lim. Port of ``nspeech_tpu/serving/synthesizer.py``.

Texts are padded to a bucket of ``text_bucket`` symbols and the batch to a
power of two, with padding rows of length 0 (finished from the first
decoder step). Each row gets its own Griffin-Lim inversion; the endpoint
trim runs on the host. A config with ``compute_dtype=bfloat16`` serves
under the bf16 policy (``ops/policy.py``): the parameters are cast once,
and the features leave the model as float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nspeech_tpu_torch.config import Config
from nspeech_tpu_torch import dsp
from nspeech_tpu_torch.data.feeder import round_up
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.ops import threefry
from nspeech_tpu_torch.ops.layers import tree_to
from nspeech_tpu_torch.ops.policy import (compute_dtype, entry_cast,
                                          set_matmul_precision, upcast)
from nspeech_tpu_torch.serving.errors import check_ids
from nspeech_tpu_torch.text import text_to_sequence
from nspeech_tpu_torch.text.symbols import PAD_ID
from nspeech_tpu_torch.train import (config_from_checkpoint, load_run_metadata,
                                     load_serving_params)


class Synthesizer:
    def __init__(self, cfg: Config, text_bucket: int = 32, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = None
        self._params = None
        self._bn_state = None
        self._cleaners = [x.strip() for x in cfg.cleaners.split(",")]
        self._text_bucket = text_bucket
        if self.device.type == "cuda":
            # full float32 (cuDNN convolutions default to TF32), and bf16
            # GEMMs that accumulate in float32
            set_matmul_precision("highest")

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        model_name: Optional[str] = None,
                        overrides: str = "", step: Optional[int] = None,
                        text_bucket: int = 32, device="cuda") -> "Synthesizer":
        """Build a Synthesizer from a checkpoint's run metadata (exact
        training-time hparams incl. the mutated num_speakers), with
        ``k=v,...`` overrides applied last."""
        cfg, name = config_from_checkpoint(checkpoint_dir, model_name, overrides)
        return cls(cfg, text_bucket=text_bucket, device=device).load(
            checkpoint_dir, name, step=step)

    def load(self, checkpoint_dir: str, model_name: Optional[str] = None,
             step: Optional[int] = None) -> "Synthesizer":
        """Restore the serving parameters of ``serving/<step>.npz`` (the
        latest step by default); ``model_name`` defaults to the run
        metadata's model."""
        if model_name is None:
            meta = load_run_metadata(checkpoint_dir)
            if meta is None or "model" not in meta:
                raise ValueError("model_name not given and no run metadata "
                                 f"at {checkpoint_dir!r}")
            model_name = meta["model"]
        model = create_model(model_name, self.cfg)
        params, bn_state = load_serving_params(checkpoint_dir, model, step=step,
                                               device=self.device)
        return self.set_variables(params, bn_state, model=model)

    def set_variables(self, params, bn_state, model=None) -> "Synthesizer":
        """Use the port's (or bridged, see ``convert``) parameters; they
        are moved to this synthesizer's device. ``model`` is a model or a
        model name (``"taco1"``, ``"taco2"``); pass it when :meth:`load`
        was not called."""
        if isinstance(model, str):
            model = create_model(model, self.cfg)
        if model is not None:
            self.model = model
        if self.model is None:
            raise ValueError("No model: pass model= or call load() first")
        # cast to the compute dtype once here, so that the model's entry
        # casts find nothing left to cast on each request
        self._params = entry_cast(tree_to(params, self.device),
                                  compute_dtype(self.cfg))
        self._bn_state = tree_to(bn_state, self.device)
        return self

    def initial_phase(self, shape) -> torch.Tensor:
        """Griffin-Lim's initial phase for a batch [n, ...]: row i is
        ``uniform(split(PRNGKey(0), n)[i], shape[1:])`` of JAX's default
        PRNG, as the JAX synthesizer draws it on its CPU route (built in
        numpy by ``ops/threefry.py``, moved to the device once per call),
        so the waveform and its endpoint are the JAX package's."""
        keys = threefry.split(threefry.prng_key(0), shape[0])
        phase = np.stack([threefry.uniform(k, shape[1:]) for k in keys])
        return torch.from_numpy(phase).to(self.device)

    def check_speakers(self, speaker_ids) -> None:
        """Raise :class:`ClientError` for a speaker id the model's speaker
        table does not have (ids below 0 and None mean the default)."""
        if self.cfg.num_speakers > 1:
            check_ids([s for s in speaker_ids if s is not None and s >= 0],
                      self.cfg.num_speakers, "speaker id")

    def synthesize(self, text: str, speaker_id: int = -1,
                   want_features=True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(waveform float32, mel [T, M], linear [T, F]); ``want_features``
        as in :meth:`synthesize_batch`."""
        wavs, mels, lins = self.synthesize_batch(
            [text], [speaker_id], want_features=want_features)
        return (wavs[0], mels[0] if mels is not None else None,
                lins[0] if lins is not None else None)

    @torch.no_grad()
    def synthesize_batch(self, texts, speaker_ids=None, want_features=True):
        """One padded forward and per-row Griffin-Lim for N texts. Returns
        (list of waveforms, mels [N, T, M], linears [N, T, F]); the feature
        arrays are None with ``want_features=False``, the linear alone with
        ``want_features="mel"``.

        A multi-speaker model raises :class:`ClientError` for a speaker id
        at or above ``num_speakers``, before anything runs (-1 is the
        default speaker). This deviates from JAX, whose ``jnp.take`` serves
        NaN rows: on the card an index out of range is a device-side assert
        that leaves the process's CUDA context unusable."""
        if self._params is None:
            raise RuntimeError("Synthesizer.set_variables() first")
        if speaker_ids is None:
            speaker_ids = [-1] * len(texts)
        self.check_speakers(speaker_ids)
        seqs = [text_to_sequence(t, self._cleaners) for t in texts]
        padded_len = round_up(max(len(s) for s in seqs), self._text_bucket)
        n = max(1, 1 << (len(seqs) - 1).bit_length())
        ids = np.full((n, padded_len), PAD_ID, np.int64)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
        lengths = np.zeros((n,), np.int64)
        lengths[: len(seqs)] = [len(s) for s in seqs]
        spk = np.zeros((n,), np.int64)
        spk[: len(seqs)] = [max(s, 0) for s in speaker_ids]
        dev = self.device
        outputs = self.model.forward(
            self._params, self._bn_state, torch.from_numpy(ids).to(dev),
            torch.from_numpy(lengths).to(dev), torch.from_numpy(spk).to(dev))
        # the features leave the model in the compute dtype; Griffin-Lim and
        # the vocoder take float32
        lin = upcast(outputs["linear_outputs"])
        wavs = dsp.inv_preemphasis(
            dsp.inv_spectrogram(lin, self.cfg, phase=self.initial_phase(lin.shape)),
            float(self.cfg.preemphasis)).cpu().numpy()
        self.last_alignment = upcast(outputs["alignments"][0]).cpu().numpy()
        self.last_decoder_steps = int(outputs["decoder_steps"][0])
        out_wavs = [w[: dsp.find_endpoint(w, self.cfg)] for w in wavs[: len(texts)]]
        if not want_features:
            return out_wavs, None, None
        mels = upcast(outputs["mel_outputs"][: len(texts)]).cpu().numpy()
        if want_features == "mel":
            return out_wavs, mels, None
        return out_wavs, mels, lin[: len(texts)].cpu().numpy()
