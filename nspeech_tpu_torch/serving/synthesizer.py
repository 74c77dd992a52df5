"""Inference wrapper: text -> (waveform, mel, linear) with a Tacotron
(1 or 2) and Griffin-Lim. Port of ``nspeech_tpu/serving/synthesizer.py``.

Texts are padded to a bucket of ``text_bucket`` symbols and the batch to a
power of two, with padding rows of length 0 (finished from the first
decoder step). Each row gets its own Griffin-Lim inversion; the endpoint
trim runs on the host. A config with ``compute_dtype=bfloat16`` serves
under the bf16 policy (``ops/policy.py``): the parameters are cast once,
and the features leave the model as float32.

With a ``mesh`` (``parallel/mesh.py``; ``--data-parallel`` in the CLIs)
the weights are replicated once per device of its data axis at load, the
batch is padded to a multiple of that axis (padding rows of length 0),
and one thread per device decodes its rows and runs their Griffin-Lim.
The shards' decodes meet once per chunk of decoder steps
(``parallel.mesh.ShardReduction`` passed to
``decoder.scan_autoregressive``): every shard runs until every row of
every shard has stopped, as the reference's one ``while_loop`` over the
sharded batch does, so each row's alignment is what one device gives.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from nspeech_tpu_torch.config import Config
from nspeech_tpu_torch import dsp
from nspeech_tpu_torch.data.feeder import round_up
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.models.decoder import scan_autoregressive
from nspeech_tpu_torch.ops import threefry
from nspeech_tpu_torch.ops.layers import tree_to
from nspeech_tpu_torch.ops.policy import (compute_dtype, entry_cast,
                                          set_matmul_precision, upcast)
from nspeech_tpu_torch.parallel.mesh import (DATA_AXIS, ShardReduction,
                                             batch_sharding, replicate,
                                             replicated)
from nspeech_tpu_torch.serving.errors import check_ids
from nspeech_tpu_torch.text import text_to_sequence
from nspeech_tpu_torch.text.symbols import PAD_ID
from nspeech_tpu_torch.train import (config_from_checkpoint, load_run_metadata,
                                     load_serving_params)


class Synthesizer:
    def __init__(self, cfg: Config, text_bucket: int = 32, device="cuda",
                 mesh=None):
        """``mesh``: a ``parallel.mesh.Mesh``; batched synthesis is then
        sharded over its data axis (``device`` is its first device)."""
        self.cfg = cfg
        self._mesh = mesh
        if mesh is not None:
            device = replicated(mesh)[0]
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
                        text_bucket: int = 32, device="cuda",
                        mesh=None) -> "Synthesizer":
        """Build a Synthesizer from a checkpoint's run metadata (exact
        training-time hparams incl. the mutated num_speakers), with
        ``k=v,...`` overrides applied last."""
        cfg, name = config_from_checkpoint(checkpoint_dir, model_name, overrides)
        return cls(cfg, text_bucket=text_bucket, device=device,
                   mesh=mesh).load(checkpoint_dir, name, step=step)

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
        if self._mesh is not None:
            self._replicas = list(zip(replicate(self._params, self._mesh),
                                      replicate(self._bn_state, self._mesh)))
        return self

    def initial_phase(self, shape, rows: slice = slice(None),
                      device=None) -> torch.Tensor:
        """Griffin-Lim's initial phase for ``rows`` of a batch [n, ...]: row
        i is ``uniform(split(PRNGKey(0), n)[i], shape[1:])`` of JAX's
        default PRNG, as the JAX synthesizer draws it on its CPU route
        (built in numpy by ``ops/threefry.py``, moved to ``device``, this
        synthesizer's by default, once per call), so the waveform and its
        endpoint are the JAX package's."""
        keys = threefry.split(threefry.prng_key(0), shape[0])[rows]
        phase = np.stack([threefry.uniform(k, shape[1:]) for k in keys])
        return torch.from_numpy(phase).to(device or self.device)

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
        if self._mesh is not None:
            # the shards split the batch evenly; the padding rows start
            # finished (length 0)
            dsize = self._mesh.shape[DATA_AXIS]
            n = -(-n // dsize) * dsize
        ids = np.full((n, padded_len), PAD_ID, np.int64)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
        lengths = np.zeros((n,), np.int64)
        lengths[: len(seqs)] = [len(s) for s in seqs]
        spk = np.zeros((n,), np.int64)
        spk[: len(seqs)] = [max(s, 0) for s in speaker_ids]
        if self._mesh is None:
            wavs, mels, lins, aligns, steps = self._decode(
                self._params, self._bn_state, self.device, ids, lengths, spk,
                slice(0, n), n)
        else:
            wavs, mels, lins, aligns, steps = self._decode_sharded(
                ids, lengths, spk, n)
        self.last_alignment = aligns[0].cpu().numpy()
        self.last_decoder_steps = int(steps[0])
        out_wavs = [w[: dsp.find_endpoint(w, self.cfg)] for w in wavs[: len(texts)]]
        if not want_features:
            return out_wavs, None, None
        mels = mels[: len(texts)].cpu().numpy()
        if want_features == "mel":
            return out_wavs, mels, None
        return out_wavs, mels, lins[: len(texts)].cpu().numpy()

    def _decode(self, params, bn_state, device, ids, lengths, spk,
                rows: slice, n: int, all_done=None):
        """The forward and Griffin-Lim of ``rows`` of the padded batch of
        ``n`` rows (numpy ids, lengths and speakers of those rows) on
        ``device``: (waveforms [rows, samples] numpy, mels, linears,
        alignments, decoder steps), the features float32 on the device.
        ``all_done``: the shards' reduction of the decode's stop check."""
        def dev(x):
            return torch.from_numpy(x).to(device)

        decode = (None if all_done is None
                  else functools.partial(scan_autoregressive, all_done=all_done))
        outputs = self.model.forward(params, bn_state, dev(ids), dev(lengths),
                                     dev(spk), decode=decode)
        # the features leave the model in the compute dtype; Griffin-Lim and
        # the vocoder take float32
        lin = upcast(outputs["linear_outputs"])
        phase = self.initial_phase((n,) + tuple(lin.shape[1:]), rows, device)
        wavs = dsp.inv_preemphasis(
            dsp.inv_spectrogram(lin, self.cfg, phase=phase),
            float(self.cfg.preemphasis)).cpu().numpy()
        return (wavs, upcast(outputs["mel_outputs"]), lin,
                upcast(outputs["alignments"]), outputs["decoder_steps"])

    def _decode_sharded(self, ids, lengths, spk, n: int):
        """:meth:`_decode` of each shard of the mesh's data axis in a thread
        of its own, the results gathered on the host in row order."""
        shards = batch_sharding(self._mesh, n)
        reduction = ShardReduction(len(shards))
        results: list = [None] * len(shards)
        errors: list = []

        def work(i):
            device, rows = shards[i]
            try:
                with torch.no_grad(), (torch.cuda.device(device)
                                       if device.type == "cuda"
                                       else contextlib.nullcontext()):
                    params, bn_state = self._replicas[i]
                    out = self._decode(params, bn_state, device, ids[rows],
                                       lengths[rows], spk[rows], rows, n,
                                       functools.partial(reduction.all, i))
                    results[i] = (out[0],) + tuple(x.cpu() for x in out[1:])
            except Exception as e:     # raised below; the other shards stop waiting
                errors.append(e)
                reduction.abort()

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(shards))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise next((e for e in errors
                        if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        wavs = np.concatenate([r[0] for r in results])
        return (wavs,) + tuple(torch.cat([r[k] for r in results])
                               for k in range(1, 5))
