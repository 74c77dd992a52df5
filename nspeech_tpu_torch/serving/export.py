"""Serving export: the text -> waveform and mel -> waveform programs as
``torch.export`` artifacts, with the weights inside.

Port of ``nspeech_tpu/serving/export.py``. :func:`export_synthesizer`
exports a loaded ``Synthesizer``'s whole forward for a static (batch,
text_len): the encoder, the decode as one ``while_loop`` that exits when
every row has stopped (``models/decoder.py`` ``while_autoregressive``),
postnet and expand, Griffin-Lim per row and the inverse pre-emphasis.
:func:`export_vocoder` exports a ``WaveNetVocoder``'s mel -> upsample ->
sampler -> mu-law decode for a static (batch, frames); its sampler is the
registered operator ``nspeech::wavenet_sample`` (``ops/cuda/wavenet_op.py``),
the CUDA kernel on the card and the plain generator on the CPU. An
artifact directory holds:

- ``module.pt2`` (``vocoder.pt2``): the program, ``torch.export.save``;
- ``export.json`` (``vocoder.json``): the host-side constants the loader
  needs (cleaners, sample rate, static shapes, endpoint-trim constants),
  with the JAX package's fields.

:class:`ExportedSynthesizer` serves an artifact without the model code,
the checkpoint or the config: it imports no module of
``nspeech_tpu_torch.models``; only text encoding and the endpoint trim run
on the host. :class:`ExportedVocoder` imports the operator's module
(which holds the plain generator) before it loads its program. An
artifact loads only under the torch version that wrote it.

Griffin-Lim's initial phase is a constant of the artifact: the JAX
loader always passes ``PRNGKey(0)`` and the shapes are static, so row i
is ``uniform(split(PRNGKey(0), batch)[i], (frames, num_freq))``, built at
export (``ops/threefry.py``) and saved as a buffer of the program, so
that the loader needs no PRNG. ``platforms`` lists the devices an
artifact may be loaded on; a loader moves the program to the device it
is asked for (``torch.export.passes.move_to_device_pass``) and refuses
one that is not listed.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from nspeech_tpu_torch.serving.errors import ClientError, check_ids
from nspeech_tpu_torch.text import text_to_sequence
from nspeech_tpu_torch.text.symbols import PAD_ID

MODULE_FILE = "module.pt2"
META_FILE = "export.json"
VOC_MODULE_FILE = "vocoder.pt2"
VOC_META_FILE = "vocoder.json"


class _Program(torch.nn.Module):
    """A tree of tensors held as buffers (so ``torch.export.save`` writes
    them into the artifact) and rebuilt by :meth:`trees`. Each leaf is
    copied: the bf16 policy's cast leaves are views of one buffer, and
    inputs of a ``while_loop`` must not alias each other."""

    def __init__(self, trees):
        super().__init__()
        leaves, self._spec = pytree.tree_flatten(trees)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"w{i}", leaf.clone())
        self._count = len(leaves)

    def trees(self):
        return pytree.tree_unflatten(
            [getattr(self, f"w{i}") for i in range(self._count)], self._spec)


class _SynthesizerProgram(_Program):
    """(ids [N, T_in], lengths [N], speaker_ids [N]) -> (wavs, mels,
    linears, alignments, decoder_steps), all float32 but the steps."""

    def __init__(self, synth, batch: int):
        cfg = synth.cfg
        phase = synth.initial_phase(
            (batch, cfg.max_iters * cfg.outputs_per_step, cfg.num_freq))
        super().__init__((synth._params, synth._bn_state, phase))
        self.model, self.cfg = synth.model, cfg

    @staticmethod
    def decode():
        """The decoder's loop in the program."""
        from nspeech_tpu_torch.models.decoder import while_autoregressive

        return while_autoregressive

    def forward(self, ids, lengths, speaker_ids):
        from nspeech_tpu_torch import dsp
        from nspeech_tpu_torch.ops.policy import upcast

        params, bn_state, phase = self.trees()
        out = self.model.forward(params, bn_state, ids, lengths, speaker_ids,
                                 decode=self.decode())
        lin = upcast(out["linear_outputs"])
        wavs = dsp.inv_preemphasis(dsp.inv_spectrogram(lin, self.cfg, phase=phase),
                                   float(self.cfg.preemphasis))
        return (wavs, upcast(out["mel_outputs"]), lin,
                upcast(out["alignments"]), out["decoder_steps"])


class _VocoderProgram(_Program):
    """(mels [N, frames, M], seed []) -> waveforms [N, frames * hop]."""

    def __init__(self, vocoder, frames: int, temperature: float, gc_ids):
        from nspeech_tpu_torch.dsp.mulaw import mu_law_decode
        from nspeech_tpu_torch.ops.cuda.wavenet_op import operator_args

        args = operator_args(vocoder.net, vocoder._params, gc_ids)
        q = vocoder.net.quantization_channels
        # mu_law_decode's table: the Q levels, decoded here, outside the trace
        levels = mu_law_decode(torch.arange(q, device=vocoder.device), q)
        super().__init__((args.pop("packed"), args.pop("weights"), levels))
        self._args = args
        self.hop, self.n_samples = vocoder._hop, frames * vocoder._hop
        self.temperature = float(temperature)

    def forward(self, mels, seed):
        from nspeech_tpu_torch.ops.upsample import upsample_on_device

        packed, weights, levels = self.trees()
        lc = upsample_on_device(mels, self.hop, self.n_samples)
        codes = torch.ops.nspeech.wavenet_sample(
            packed, weights, lc, seed, self.temperature,
            self._args["net_config"], self._args["weights_spec"],
            self._args["gc_ids"])
        return levels[codes.to(torch.int64)]


def _platforms(platforms, device: torch.device):
    return sorted({device.type, *(platforms or ())})


def _save(program, args, out_dir: str, module_file: str, meta_file: str,
          meta: dict) -> str:
    with torch.no_grad():
        exported = torch.export.export(program, args, strict=False)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, module_file))
    with open(os.path.join(out_dir, meta_file), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def export_synthesizer(synth, out_dir: str, text_len: int = 64, batch: int = 1,
                       platforms: Optional[Sequence[str]] = None) -> str:
    """Export ``synth`` (a loaded Synthesizer) for (batch, text_len)
    inputs, traced on its device. Shapes are static: requests pad to
    them. ``platforms`` lists the devices the artifact may be loaded on
    besides the synthesizer's (``("cpu", "cuda")``). A synthesizer under
    the bf16 policy exports its bf16 program. Returns ``out_dir``."""
    if synth._params is None:
        raise ValueError("Synthesizer must be loaded before export")
    dev = synth.device
    args = (torch.zeros(batch, text_len, dtype=torch.int64, device=dev),
            torch.ones(batch, dtype=torch.int64, device=dev),
            torch.zeros(batch, dtype=torch.int64, device=dev))
    cfg = synth.cfg
    meta = {
        "batch": batch,
        "text_len": text_len,
        "platforms": _platforms(platforms, dev),
        "cleaners": cfg.cleaners,
        "preemphasis": float(cfg.preemphasis),
        # the program applies inv_preemphasis; loaders must not re-apply
        "preemphasis_in_program": True,
        "sample_rate": int(cfg.sample_rate),
        # endpoint trim constants (dsp.find_endpoint's inputs)
        "min_silence_sec": 0.8,
        "silence_threshold_db": -40.0,
        # the speaker table's size: ids are checked on the host before
        # they index it (on the card an index out of range is a
        # device-side assert)
        "num_speakers": int(cfg.num_speakers),
    }
    return _save(_SynthesizerProgram(synth, batch), args, out_dir, MODULE_FILE,
                 META_FILE, meta)


def export_vocoder(vocoder, out_dir: str, frames: int, batch: int = 1,
                   temperature: float = 1.0,
                   gc_ids: Optional[Sequence[int]] = None,
                   platforms: Optional[Sequence[str]] = None) -> str:
    """Export a loaded WaveNetVocoder as (mel [N, frames, M], seed) ->
    waveform [N, frames * hop], traced on its device. The mel is
    upsampled and the codes mu-law decoded inside the program; the
    sampler is ``nspeech::wavenet_sample`` (the CUDA kernel on the card,
    so an artifact keeps the port's no-fallback rule). The temperature
    and, for a net with global conditioning, ``gc_ids`` (one per stream)
    are fixed at export; the seed stays a call argument."""
    net = vocoder.net
    if net is None or vocoder._params is None:
        raise ValueError("Vocoder must be loaded before export")
    if net.lc_channels <= 0:
        raise ValueError("Vocoder was trained without local conditioning "
                         "(lc_channels=0); it cannot follow a mel")
    if gc_ids is not None:
        if not net.gc_channels:
            raise ValueError("gc_ids given but the net has gc_channels=0")
        if len(gc_ids) != batch:
            raise ValueError(f"{len(gc_ids)} gc_ids for a batch of {batch}")
        check_ids(gc_ids, net.gc_cardinality, "gc id")
    dev = vocoder.device
    args = (torch.zeros(batch, frames, net.lc_channels, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))
    meta = {
        "batch": batch,
        "frames": frames,
        "hop": vocoder._hop,
        "num_mels": int(net.lc_channels),
        "temperature": float(temperature),
        "gc_ids": None if gc_ids is None else [int(i) for i in gc_ids],
        "platforms": _platforms(platforms, dev),
        "sample_rate": int(vocoder.cfg.sample_rate),
    }
    return _save(_VocoderProgram(vocoder, frames, temperature, gc_ids), args,
                 out_dir, VOC_MODULE_FILE, VOC_META_FILE, meta)


def _load(artifact_dir: str, module_file: str, meta_file: str, device):
    """(meta, callable program on ``device``)."""
    from torch.export.passes import move_to_device_pass

    with open(os.path.join(artifact_dir, meta_file)) as f:
        meta = json.load(f)
    device = torch.device(device)
    if device.type not in meta["platforms"]:
        raise ValueError(f"{artifact_dir} was exported for {meta['platforms']}, "
                         f"not {device.type} (export with platforms=)")
    if device.type == "cuda":
        from nspeech_tpu_torch.ops.policy import set_matmul_precision

        set_matmul_precision("highest")   # as the live Synthesizer: no TF32
    program = torch.export.load(os.path.join(artifact_dir, module_file))
    return meta, move_to_device_pass(program, device).module()


class ExportedVocoder:
    """Serve mel -> waveform from an :func:`export_vocoder` artifact, on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, artifact_dir: str, device="cuda"):
        import nspeech_tpu_torch.ops.cuda.wavenet_op  # noqa: F401  (the operator)

        self.device = torch.device(device)
        self.meta, self._program = _load(artifact_dir, VOC_MODULE_FILE,
                                         VOC_META_FILE, self.device)

    @torch.no_grad()
    def vocode(self, mel: np.ndarray, seed: int = 0) -> np.ndarray:
        """mel [T, M] (T <= the exported frames; padded up by repeating its
        last frame) -> waveform trimmed back to T * hop samples."""
        mel = np.asarray(mel, np.float32)
        frames = self.meta["frames"]
        if mel.shape[0] == 0:
            raise ClientError("mel is empty (0 frames)")
        if mel.shape[0] > frames:
            raise ClientError(f"mel has {mel.shape[0]} frames; this artifact "
                              f"was exported for frames={frames}")
        if mel.shape[1] != self.meta["num_mels"]:
            raise ClientError(f"mel has {mel.shape[1]} channels; expected "
                              f"{self.meta['num_mels']}")
        n, t_real = self.meta["batch"], mel.shape[0]
        mels = np.zeros((n, frames, mel.shape[1]), np.float32)
        mels[0, :t_real] = mel
        # edge-hold the pad: the live vocoder's upsample holds the last
        # frame past it, while the program's clip bound is `frames`;
        # repeating the last frame makes the final hop's blend the same
        mels[0, t_real:] = mel[t_real - 1]
        wavs = self._program(
            torch.from_numpy(mels).to(self.device),
            torch.tensor(seed, dtype=torch.int64, device=self.device))
        return wavs[0, : t_real * self.meta["hop"]].cpu().numpy()


class ExportedSynthesizer:
    """Serve text -> waveform from an :func:`export_synthesizer` artifact,
    on ``device`` (``cuda`` unless the caller asks for the CPU). Needs no
    model code, checkpoint or config: the program (weights included) is
    loaded and called; only text encoding and the endpoint trim run on
    the host."""

    def __init__(self, artifact_dir: str, device="cuda"):
        self.device = torch.device(device)
        self.meta, self._program = _load(artifact_dir, MODULE_FILE, META_FILE,
                                         self.device)
        self._cleaners = [c.strip() for c in self.meta["cleaners"].split(",")]

    def synthesize(self, text: str, speaker_id: int = -1
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(waveform float32, mel [T, M], linear [T, F])."""
        wavs, mels, lins = self.synthesize_batch([text], [speaker_id])
        return wavs[0], mels[0], lins[0]

    @torch.no_grad()
    def synthesize_batch(self, texts, speaker_ids=None):
        """Synthesis through the program, ``batch`` texts per call (the
        artifact's static batch; more run in groups). Returns (list of
        waveforms, mels [N, T, M], linears [N, T, F]). A text longer than
        ``text_len`` or a speaker id outside the table raises
        :class:`ClientError` before anything runs."""
        if speaker_ids is None:
            speaker_ids = [-1] * len(texts)
        if self.meta["num_speakers"] > 1:
            check_ids([s for s in speaker_ids if s is not None and s >= 0],
                      self.meta["num_speakers"], "speaker id")
        n, t = self.meta["batch"], self.meta["text_len"]
        seqs = [text_to_sequence(x, self._cleaners) for x in texts]
        for x, seq in zip(texts, seqs):
            if len(seq) > t:
                raise ClientError(f"text {x[:40]!r} encodes to {len(seq)} ids; "
                                  f"this artifact was exported for text_len={t}")
        out_wavs, out_mels, out_lins = [], [], []
        for g in range(0, len(seqs), n):
            group = seqs[g: g + n]
            ids = np.full((n, t), PAD_ID, np.int64)
            lengths = np.zeros((n,), np.int64)
            spk = np.zeros((n,), np.int64)
            for i, seq in enumerate(group):
                ids[i, : len(seq)] = seq
                lengths[i] = len(seq)
                spk[i] = max(speaker_ids[g + i], 0)
            wavs, mels, lins, _aligns, _steps = self._program(
                *(torch.from_numpy(a).to(self.device) for a in (ids, lengths, spk)))
            wavs = wavs.cpu().numpy()
            for i in range(len(group)):
                out_wavs.append(self._trim(wavs[i]))
                out_mels.append(mels[i].cpu().numpy())
                out_lins.append(lins[i].cpu().numpy())
        return out_wavs, np.stack(out_mels), np.stack(out_lins)

    def _trim(self, wav: np.ndarray) -> np.ndarray:
        """The endpoint trim (``dsp.find_endpoint``'s numpy twin), so the
        loader needs no DSP module or config."""
        window = int(self.meta["sample_rate"] * self.meta["min_silence_sec"])
        hop = window // 4
        threshold = 10.0 ** (self.meta["silence_threshold_db"] * 0.05)
        for x in range(hop, len(wav) - window, hop):
            if np.max(wav[x: x + window]) < threshold:
                return wav[: x + hop]
        return wav
