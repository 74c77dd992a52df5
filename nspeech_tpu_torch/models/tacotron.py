"""Tacotron-1: character embedding -> encoder prenet -> encoder CBHG ->
attention decoder (GRU attention cell, output projection, two residual
GRUs, r frames per step) -> post-CBHG -> linear spectrogram.

Port of ``nspeech_tpu/models/tacotron.py``: :meth:`Tacotron1.forward` is
inference (autoregressive, early stop, ``torch.no_grad``);
:meth:`Tacotron1.forward_train` is the teacher-forced forward of training
(both prenets drop at ``drop_rate``, training-mode batch norm) and of the
holdout loss; :func:`tacotron_loss` is both Tacotrons' loss. The decoder
prenet reads [input frame; previous attention context] (the reference's
composition, not the paper's). The decoder frames are the mel: there is
no postnet, so the model has no ``postnet_residual`` and the stream needs
no postnet halo. The streaming hooks (:meth:`Tacotron1.attention_context`,
:meth:`Tacotron1.make_eval_step`) are the pieces :meth:`Tacotron1.forward`
is built from, as in :mod:`nspeech_tpu_torch.models.tacotron2`, with the
same entry casts to ``compute_dtype`` (``ops/policy.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nspeech_tpu_torch.config import Config
from nspeech_tpu_torch.models import attention as A
from nspeech_tpu_torch.models import decoder as D
from nspeech_tpu_torch.models import modules as M
from nspeech_tpu_torch.ops import deferred as DF
from nspeech_tpu_torch.ops import layers as L
from nspeech_tpu_torch.ops import policy as P
from nspeech_tpu_torch.text.symbols import symbols

GRU_UNITS = 128   # the CBHGs' GRU width, fixed by the reference


class Tacotron1:
    name = "taco1"

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.multi_speaker = cfg.num_speakers > 1
        self._enc_meta = {"K": cfg.encoder_cbhg_banks, "gru_units": GRU_UNITS,
                          "in_dim": cfg.encoder_prenet[-1]}
        self._post_meta = {"K": cfg.post_cbhg_banks, "gru_units": GRU_UNITS,
                           "in_dim": cfg.num_mels}
        self._memory_dim = 2 * GRU_UNITS

    def init(self, seed: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(params, bn_state) drawn from ``numpy.random.default_rng(seed)``,
        as CPU tensors, in the JAX package's tree layout."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        M_dim, r = cfg.num_mels, cfg.outputs_per_step
        params: Dict[str, Any] = {}
        state: Dict[str, Any] = {}
        params["embedding"] = L.init_embedding(rng, len(symbols), cfg.embedding_dim)
        spk_dim = None
        if self.multi_speaker:
            params["speaker_embed"] = {"table": L.glorot_uniform(
                rng, (cfg.num_speakers, cfg.speaker_embed_dim),
                cfg.num_speakers, cfg.speaker_embed_dim)}
            spk_dim = cfg.speaker_embed_dim
        params["encoder_prenet"] = L.init_prenet(rng, cfg.embedding_dim,
                                                 cfg.encoder_prenet)
        params["encoder_cbhg"], state["encoder_cbhg"], _ = M.init_cbhg(
            rng, cfg.encoder_prenet[-1], cfg.encoder_cbhg_banks,
            list(cfg.encoder_cbhg_bank_sizes), speaker_dim=spk_dim)
        params["attention"] = A.init_attention(
            rng, cfg.attention_type, cfg.attention_dim, self._memory_dim,
            cfg.attention_dim)
        params["decoder_prenet"] = L.init_prenet(
            rng, M_dim + self._memory_dim, [256, 128])
        attn_in = 128
        if self.multi_speaker:
            params["spk_prenet"] = L.init_dense(rng, spk_dim, 128)
            attn_in += 128
        params["attn_gru"] = L.init_gru(rng, attn_in, cfg.attention_dim)
        params["out_proj"] = L.init_dense(
            rng, cfg.attention_dim + self._memory_dim, cfg.decoder_dim)
        params["gru2"] = L.init_gru(rng, cfg.decoder_dim, cfg.decoder_dim)
        params["gru3"] = L.init_gru(rng, cfg.decoder_dim, cfg.decoder_dim)
        params["frame_proj"] = L.init_dense(rng, cfg.decoder_dim, M_dim * r)
        params["post_cbhg"], state["post_cbhg"], _ = M.init_cbhg(
            rng, M_dim, cfg.post_cbhg_banks,
            list(cfg.post_cbhg_bank_sizes) + [M_dim])
        params["linear_proj"] = L.init_dense(rng, 2 * GRU_UNITS, cfg.num_freq)
        return params, state

    def _make_step(self, params, keys_mem, values, mask, spk,
                   is_training: bool = False,
                   generator: Optional[torch.Generator] = None,
                   deferred: Optional[DF.Taps] = None):
        """The decoder step ``(carry, x) -> (carry, (out, align))``. In
        training the prenet drops at ``drop_rate`` (from ``generator``)
        and attention is not windowed. With ``deferred`` (taps from
        :meth:`deferred_zero_inputs`) the three GRU cells and both
        projections defer their weight gradients (``ops/deferred.py``)."""
        cfg = self.cfg
        att_type = cfg.attention_type
        drop = cfg.drop_rate if is_training else 0.0
        win_fwd = 0 if is_training else int(cfg.get("attention_win_fwd", 0))
        win_back = int(cfg.get("attention_win_back", 1))
        spk_pre = (None if spk is None
                   else L.dense(params["spk_prenet"], spk, L.softsign))

        def gru(name, x, h):
            if deferred is not None:
                return DF.gru_cell_deferred(params[name], x, h, deferred, name)
            return L.gru_cell(params[name], x, h)

        def dense(name, x):
            if deferred is not None:
                return DF.dense_deferred(params[name], x, deferred, name)
            return L.dense(params[name], x)

        def step(carry, x):
            h1, context, align, h2, h3 = carry
            pre = L.prenet(params["decoder_prenet"],
                           torch.cat([x, context], dim=-1), drop, generator)
            if spk_pre is not None:
                pre = torch.cat([pre, spk_pre], dim=-1)
            h1 = gru("attn_gru", pre, h1)
            m = A.window_mask(align, mask, win_back, win_fwd) if win_fwd > 0 else mask
            context, align = A.attention_step(params["attention"], att_type, h1,
                                              align, keys_mem, values, m)
            proj = dense("out_proj", torch.cat([h1, context], dim=-1))
            g2 = gru("gru2", proj, h2)
            o2 = proj + g2
            g3 = gru("gru3", o2, h3)
            out = dense("frame_proj", o2 + g3)
            return (h1, context, align, g2, g3), (out, align)

        return step

    def deferred_zero_inputs(self, batch: int, steps: int,
                             t_in: Optional[int] = None,
                             t_out: Optional[int] = None) -> DF.Taps:
        """The taps of a deferred training forward (``ops/deferred.py``):
        both kernels of each decoder GRU and the two projections over
        ``steps`` decoder steps, named and shaped as the JAX package's zero
        injections. ``t_in`` / ``t_out`` are taken for Tacotron-2's
        signature: the CBHG BiGRUs keep autograd's gradients, as in the
        JAX package (their recurrent kernels are [128, ...])."""
        del t_in, t_out
        cfg = self.cfg
        shapes = {}
        for name, units in (("attn_gru", cfg.attention_dim),
                            ("gru2", cfg.decoder_dim), ("gru3", cfg.decoder_dim)):
            shapes[name + "_gate"] = (steps, batch, 2 * units)
            shapes[name + "_cand"] = (steps, batch, units)
        shapes["out_proj"] = (steps, batch, cfg.decoder_dim)
        shapes["frame_proj"] = (steps, batch, cfg.num_mels * cfg.outputs_per_step)
        return DF.Taps(shapes)

    def deferred_param_grads(self, taps: DF.Taps):
        """``{param name: gradients}`` of the deferred products from
        ``taps``."""
        g = {}
        for cell in ("attn_gru", "gru2", "gru3"):
            d = DF.matmul_grads(*taps.stacked(cell + "_gate"), "gate_kernel",
                                "gate_bias")
            d.update(DF.matmul_grads(*taps.stacked(cell + "_cand"),
                                     "cand_kernel", "cand_bias"))
            g[cell] = d
        for name in ("out_proj", "frame_proj"):
            g[name] = DF.matmul_grads(*taps.stacked(name))
        return g

    def deferred_merge_grads(self, grads, taps: DF.Taps):
        """Fill the weight gradients that a deferred forward left out of
        ``grads`` (autograd's) from ``taps``."""
        for name, g in self.deferred_param_grads(taps).items():
            grads[name] = {k: v.to(grads[name][k].dtype)
                           for k, v in g.items() if k in grads[name]}
        return grads

    def _cast(self, tree):
        return P.entry_cast(tree, P.compute_dtype(self.cfg))

    def _decoder_carry0(self, batch: int, t_in: int, device):
        cfg = self.cfg
        dtype = P.carry_dtype(cfg)

        def z(*shape):
            return torch.zeros(*shape, device=device, dtype=dtype)

        return (z(batch, cfg.attention_dim), z(batch, self._memory_dim),
                A.initial_alignments(cfg.attention_type, batch, t_in, device,
                                     dtype),
                z(batch, cfg.decoder_dim), z(batch, cfg.decoder_dim))

    # -- streaming hooks ------------------------------------------------------

    def _encode(self, params, state, text_inputs, input_lengths, speaker_ids,
                is_training: bool, generator=None):
        """``(step_ctx, encoder CBHG BN state)``; in training the encoder
        prenet drops at ``drop_rate``."""
        t_in = text_inputs.shape[1]
        spk = None
        if self.multi_speaker:
            spk = params["speaker_embed"]["table"][speaker_ids]
        pre = L.prenet(params["encoder_prenet"],
                       L.embedding(params["embedding"], text_inputs),
                       self.cfg.drop_rate if is_training else 0.0, generator)
        enc_out, enc_state = M.with_state(
            M.cbhg(params["encoder_cbhg"], state["encoder_cbhg"],
                   self._enc_meta, pre, input_lengths, spk, is_training),
            state["encoder_cbhg"], is_training)
        keys_mem = A.prepare_memory(params["attention"], enc_out)
        # max(len, 1) keeps the softmax finite for length-0 padding rows
        mask = (torch.arange(t_in, device=text_inputs.device)[None, :]
                < torch.clamp(input_lengths, min=1)[:, None])
        return (keys_mem, enc_out, mask, spk), enc_state

    @torch.no_grad()
    def attention_context(self, params, state, text_inputs: torch.Tensor,
                          input_lengths: torch.Tensor,
                          speaker_ids: Optional[torch.Tensor] = None):
        """Encoder side of inference: ``(step_ctx, decoder carry0)`` for
        :meth:`make_eval_step` and the decoder's chunked decode."""
        n, t_in = text_inputs.shape
        ctx, _ = self._encode(self._cast(params), state, text_inputs,
                              input_lengths, speaker_ids, False)
        return ctx, self._decoder_carry0(n, t_in, text_inputs.device)

    def make_eval_step(self, params, step_ctx):
        """The decoder step ``(carry, x) -> (carry, (out, align))`` over
        :meth:`attention_context`'s ``step_ctx``."""
        keys_mem, enc_out, mask, spk = step_ctx
        return self._make_step(self._cast(params), keys_mem, enc_out, mask, spk)

    @torch.no_grad()
    def forward(self, params, state, text_inputs: torch.Tensor,
                input_lengths: torch.Tensor,
                speaker_ids: Optional[torch.Tensor] = None,
                decode=None) -> Dict[str, torch.Tensor]:
        """Inference forward: text ids [N, T_in] -> mel_outputs [N, T, M],
        linear_outputs [N, T, F], alignments [N, T_in, S], decoder_steps [N].
        Rows of length 0 are padding: finished from the start. ``decode``
        is the decoder's loop: the chunked :func:`decoder.scan_autoregressive`
        of the live path (the default), or :func:`decoder.while_autoregressive`,
        which ``torch.export`` traces (``serving/export.py``)."""
        cfg = self.cfg
        params = self._cast(params)
        ctx, carry0 = self.attention_context(params, state, text_inputs,
                                             input_lengths, speaker_ids)
        outs, aligns, steps = (decode or D.scan_autoregressive)(
            self.make_eval_step(params, ctx), carry0, text_inputs.shape[0],
            cfg.num_mels, cfg.outputs_per_step, cfg.max_iters,
            stop_threshold=cfg.get("stop_threshold", 0.0),
            initial_finished=input_lengths < 1)
        mel_outputs = D.assemble_outputs(outs, cfg.num_mels)
        post_out = M.cbhg(params["post_cbhg"], state["post_cbhg"],
                          self._post_meta, mel_outputs, None, None)
        return {"mel_outputs": mel_outputs,
                "linear_outputs": L.dense(params["linear_proj"], post_out),
                "alignments": D.assemble_alignments(aligns),
                "decoder_steps": steps}

    def forward_train(self, params, state, text_inputs: torch.Tensor,
                      input_lengths: torch.Tensor,
                      speaker_ids: Optional[torch.Tensor],
                      mel_targets: torch.Tensor, is_training: bool = True,
                      generator: Optional[torch.Generator] = None,
                      deferred: Optional[DF.Taps] = None):
        """Teacher-forced forward, as :meth:`Tacotron2.forward_train`:
        returns ``(outputs, new_bn_state)``."""
        cfg = self.cfg
        n, t_in = text_inputs.shape
        params = self._cast(params)
        mel_targets = self._cast(mel_targets)
        ctx, enc_state = self._encode(params, state, text_inputs,
                                      input_lengths, speaker_ids, is_training,
                                      generator)
        step = self._make_step(params, *ctx, is_training=is_training,
                               generator=generator, deferred=deferred)
        ss = float(cfg.get("scheduled_sampling_ratio", 0.0)) if is_training else 0.0
        outs, aligns = D.scan_teacher(
            step, self._decoder_carry0(n, t_in, text_inputs.device),
            D.teacher_frames(mel_targets, cfg.outputs_per_step), ss, generator)
        mel_outputs = D.assemble_outputs(outs, cfg.num_mels)
        alignments = D.assemble_alignments(aligns)
        post_out, post_state = M.with_state(
            M.cbhg(params["post_cbhg"], state["post_cbhg"], self._post_meta,
                   mel_outputs, None, None, is_training),
            state["post_cbhg"], is_training)
        outputs = {"mel_outputs": mel_outputs,
                   "linear_outputs": L.dense(params["linear_proj"], post_out),
                   "alignments": alignments}
        guided = D.maybe_guided_attention(cfg, alignments, input_lengths,
                                          mel_targets, is_training)
        if guided is not None:
            outputs["guided_attention"] = guided
        return outputs, {"encoder_cbhg": enc_state, "post_cbhg": post_state}

    def loss(self, outputs, mel_targets, linear_targets):
        """(loss, metrics) with a 3 kHz priority band."""
        return tacotron_loss(self.cfg, outputs, mel_targets, linear_targets,
                             priority_hz=3000)


def tacotron_loss(cfg, outputs, mel_targets, linear_targets, priority_hz):
    """``(loss, metrics)``: mean L1 of the mel plus half the mean L1 of the
    linear spectrogram and half that over its bins below ``priority_hz``
    (means over the padded frames too), plus the weighted guided-attention
    penalty when the forward computed one. Metrics: ``loss``,
    ``loss_mel``, ``loss_linear``, ``attention_sharpness`` (the mean peak
    alignment weight per decoder step; collapsed attention drops it toward
    1/T_in) and ``loss_guided_attention`` when on. Computed in float32
    (or wider) whatever the compute dtype."""
    outputs = {k: P.upcast(v) for k, v in outputs.items()}
    mel_loss = torch.mean(torch.abs(mel_targets - outputs["mel_outputs"]))
    l1 = torch.abs(linear_targets - outputs["linear_outputs"])
    n_priority = int(priority_hz / (cfg.sample_rate * 0.5) * cfg.num_freq)
    linear_loss = 0.5 * torch.mean(l1) + 0.5 * torch.mean(l1[:, :, :n_priority])
    loss = mel_loss + linear_loss
    metrics = {"loss_mel": mel_loss, "loss_linear": linear_loss,
               "attention_sharpness": torch.mean(
                   torch.max(outputs["alignments"], dim=1).values)}
    loss = D.apply_guided_loss(cfg, outputs, loss, metrics)
    metrics["loss"] = loss
    return loss, metrics
