"""Tacotron-2: conv+BiLSTM encoder, location-sensitive attention, LSTM
decoder, postnet residual, conv+BiLSTM expand network to linear spectra.

Port of ``nspeech_tpu/models/tacotron2.py``. The decoder step is prenet ->
attention LSTM -> location-sensitive attention -> 2 LSTMs -> r-frame
projection. :meth:`Tacotron2.forward` is inference: the decode runs by
:func:`decoder.scan_autoregressive` with early stop, under
``torch.no_grad``. :meth:`Tacotron2.forward_train` is the teacher-forced
forward of training (prenet dropout, training-mode batch norm, scheduled
sampling, guided attention) and of the holdout loss, and
:meth:`Tacotron2.loss` its loss. The streaming hooks
(:meth:`Tacotron2.attention_context`, :meth:`Tacotron2.make_eval_step`,
:meth:`Tacotron2.postnet_residual`) are the pieces :meth:`forward` is
built from, so the one-shot path and the stream share one encoder, one
decoder step and one postnet. Each entry casts the parameters (and the
teacher frames) to ``compute_dtype`` (``ops/policy.py``); the outputs come
out in it and :meth:`loss` computes in float32.

Inside ``collectives.tensor_parallel(tp)`` :meth:`forward_train` (and
:meth:`deferred_zero_inputs`) run on this model rank's slices of the
weights that :data:`tp_rules` shard (``parallel/tensor.py``): the
decoder's and the BiLSTMs' cells over the rank's units, the attention
energy over its attention dims, the convs over its channels, the prenet,
frame and linear projections as column and row products. The outputs,
the alignments and the loss are whole on every model rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nspeech_tpu_torch.config import Config
from nspeech_tpu_torch.models import attention as A
from nspeech_tpu_torch.models import decoder as D
from nspeech_tpu_torch.models import modules as M
from nspeech_tpu_torch.models.tacotron import tacotron_loss
from nspeech_tpu_torch.ops import deferred as DF
from nspeech_tpu_torch.ops import layers as L
from nspeech_tpu_torch.ops import policy as P
from nspeech_tpu_torch.parallel import collectives
from nspeech_tpu_torch.parallel.tensor import TACO2_TP_RULES
from nspeech_tpu_torch.text.symbols import symbols


class Tacotron2:
    name = "taco2"
    tp_rules = TACO2_TP_RULES

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.multi_speaker = cfg.num_speakers > 1
        self._enc_meta = {"lstm_units": cfg.encoder_lstm_units}
        self._expand_meta = {"lstm_units": cfg.expand_lstm_units}
        self._memory_dim = 2 * cfg.encoder_lstm_units

    def init(self, seed: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(params, bn_state) drawn from ``numpy.random.default_rng(seed)``,
        as CPU tensors, in the JAX package's tree layout."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        M_dim, r = cfg.num_mels, cfg.outputs_per_step
        params: Dict[str, Any] = {}
        state: Dict[str, Any] = {}
        params["embedding"] = L.init_embedding(rng, len(symbols), cfg.embedding_dim)
        if self.multi_speaker:
            params["speaker_embed"] = {"table": L.glorot_uniform(
                rng, (cfg.num_speakers, cfg.speaker_embed_dim),
                cfg.num_speakers, cfg.speaker_embed_dim)}
        params["encoder"], state["encoder"], _ = M.init_conv_and_lstm(
            rng, cfg.embedding_dim, cfg.encoder_conv_layers,
            cfg.encoder_conv_width, cfg.encoder_conv_channels,
            cfg.encoder_lstm_units)
        # location-sensitive whatever attention_type says, as in the
        # reference
        params["attention"] = A.init_attention(
            rng, "location_sensitive", cfg.attention_dim, self._memory_dim,
            cfg.attention_dim)
        params["decoder_prenet"] = L.init_prenet(
            rng, M_dim + self._memory_dim, [256, 128])
        attn_in = 128
        if self.multi_speaker:
            params["spk_prenet"] = L.init_dense(rng, cfg.speaker_embed_dim, 128)
            attn_in += 128
        params["attn_lstm"] = L.init_lstm(rng, attn_in, cfg.attention_dim)
        params["lstm1"] = L.init_lstm(
            rng, cfg.attention_dim + self._memory_dim, cfg.decoder_lstm_units)
        params["lstm2"] = L.init_lstm(rng, cfg.decoder_lstm_units,
                                      cfg.decoder_lstm_units)
        params["frame_proj"] = L.init_dense(rng, cfg.decoder_lstm_units, M_dim * r)
        params["postnet"], state["postnet"] = M.init_postnet(
            rng, M_dim, cfg.postnet_conv_layers, cfg.postnet_conv_width,
            cfg.postnet_conv_channels)
        params["expand"], state["expand"], _ = M.init_conv_and_lstm(
            rng, M_dim, cfg.expand_conv_layers, cfg.expand_conv_width,
            cfg.expand_conv_channels, cfg.expand_lstm_units)
        params["linear_proj"] = L.init_dense(rng, 2 * cfg.expand_lstm_units,
                                             cfg.num_freq)
        return params, state

    def _make_step(self, params, keys_mem, values, mask, spk,
                   is_training: bool = False,
                   generator: Optional[torch.Generator] = None,
                   deferred: Optional[DF.Taps] = None, tp=None):
        """The decoder step ``(carry, x) -> (carry, (out, align))``. In
        training the prenet drops at ``drop_rate`` (from ``generator``)
        and attention is not windowed. With ``deferred`` (taps from
        :meth:`deferred_zero_inputs`) the three LSTM cells and the frame
        projection defer their weight gradients (``ops/deferred.py``).
        With ``tp`` the carry's cell states are this model rank's units,
        its ``h`` whole."""
        cfg = self.cfg
        drop = cfg.drop_rate if is_training else 0.0
        win_fwd = 0 if is_training else int(cfg.get("attention_win_fwd", 0))
        win_back = int(cfg.get("attention_win_back", 1))
        spk_pre = (None if spk is None
                   else L.dense(params["spk_prenet"], spk, L.softsign))

        def lstm(name, x, state):
            if deferred is not None:
                return DF.lstm_cell_deferred(params[name], x, state, deferred,
                                             name, tp=tp)
            return L.lstm_cell(params[name], x, state, tp=tp)

        def step(carry, x):
            (c1, h1), context, align, (c2, h2), (c3, h3) = carry
            pre = L.prenet(params["decoder_prenet"],
                           torch.cat([x, context], dim=-1), drop, generator, tp)
            if spk_pre is not None:
                pre = torch.cat([pre, spk_pre], dim=-1)
            # each cell's output is its state's h, whole; under tp the
            # frame projection reads lstm2's output, the rank's units
            _, (c1, h1) = lstm("attn_lstm", pre, (c1, h1))
            m = A.window_mask(align, mask, win_back, win_fwd) if win_fwd > 0 else mask
            context, align = A.attention_step(params["attention"],
                                              "location_sensitive", h1, align,
                                              keys_mem, values, m, tp)
            _, (c2, h2) = lstm("lstm1", torch.cat([h1, context], dim=-1),
                               (c2, h2))
            out3, (c3, h3) = lstm("lstm2", h2, (c3, h3))
            if deferred is not None:
                out = DF.dense_deferred(params["frame_proj"], out3, deferred,
                                        "frame_proj", tp=tp)
            else:
                out = L.row_dense(params["frame_proj"], out3, tp)
            return ((c1, h1), context, align, (c2, h2), (c3, h3)), (out, align)

        return step

    def deferred_zero_inputs(self, batch: int, steps: int,
                             t_in: Optional[int] = None,
                             t_out: Optional[int] = None) -> DF.Taps:
        """The taps of a deferred training forward (``ops/deferred.py``):
        the attention LSTM, the two decoder LSTMs and the frame projection
        over ``steps`` decoder steps; with ``t_in`` / ``t_out`` also the
        recurrent kernels of the encoder / expand BiLSTM (loops at text
        and frame rate). Named and shaped as the JAX package's zero
        injections; inside ``collectives.tensor_parallel`` the cells' at
        this model rank's units."""
        cfg = self.cfg
        tp = collectives.current_tp()
        split = 1 if tp is None else tp.world
        shapes = {
            "attn_lstm": (steps, batch, 4 * cfg.attention_dim // split),
            "lstm1": (steps, batch, 4 * cfg.decoder_lstm_units // split),
            "lstm2": (steps, batch, 4 * cfg.decoder_lstm_units // split),
            "frame_proj": (steps, batch, cfg.num_mels * cfg.outputs_per_step),
        }
        if t_in is not None:
            shapes["encoder_lstm"] = (t_in, 2 * batch,
                                      4 * cfg.encoder_lstm_units // split)
        if t_out is not None:
            shapes["expand_lstm"] = (t_out, 2 * batch,
                                     4 * cfg.expand_lstm_units // split)
        return DF.Taps(shapes)

    def deferred_merge_grads(self, grads, taps: DF.Taps):
        """Fill the weight gradients that a deferred forward left out of
        ``grads`` (autograd's) from ``taps``: each decoder product's kernel
        and bias, and the recurrent rows of each tapped BiLSTM kernel."""
        for name in ("attn_lstm", "lstm1", "lstm2", "frame_proj"):
            g = DF.matmul_grads(*taps.stacked(name))
            grads[name] = {k: v.to(grads[name][k].dtype)
                           for k, v in g.items() if k in grads[name]}
        for comp in ("encoder", "expand"):
            key = comp + "_lstm"
            if key not in taps:
                continue
            for d, dwh in zip(("lstm_fw", "lstm_bw"),
                              DF.bilstm_wh_grads(*taps.stacked(key))):
                # the recurrent rows are zero in autograd's gradient (the
                # loop read them detached); the input rows and the bias
                # got theirs through the hoisted input product
                k = grads[comp][d]["kernel"]
                k[-dwh.shape[0]:] = dwh.to(k.dtype)
        return grads

    def _cast(self, tree):
        return P.entry_cast(tree, P.compute_dtype(self.cfg))

    def _decoder_carry0(self, batch: int, t_in: int, device, tp=None):
        """The decoder's zero carry; with ``tp`` the cell states at this
        model rank's units."""
        cfg = self.cfg
        dtype = P.carry_dtype(cfg)
        split = 1 if tp is None else tp.world

        def z(*shape):
            return torch.zeros(*shape, device=device, dtype=dtype)

        def cell(units):
            return z(batch, units // split), z(batch, units)

        return (cell(cfg.attention_dim), z(batch, self._memory_dim),
                A.initial_alignments("location_sensitive", batch, t_in, device,
                                     dtype),
                cell(cfg.decoder_lstm_units), cell(cfg.decoder_lstm_units))

    # -- streaming hooks ------------------------------------------------------

    def _encode(self, params, state, text_inputs, input_lengths, speaker_ids,
                is_training: bool, deferred: Optional[DF.Taps] = None, tp=None):
        """``(step_ctx, encoder BN state)``: the attention keys (with
        ``tp``, this model rank's units), memory, mask and speaker
        embedding the decoder step reads."""
        t_in = text_inputs.shape[1]
        embedded = L.embedding(params["embedding"], text_inputs)
        spk = None
        if self.multi_speaker:
            spk = params["speaker_embed"]["table"][speaker_ids]
        enc_out, enc_state = M.with_state(
            M.conv_and_lstm(params["encoder"], state["encoder"], self._enc_meta,
                            embedded, input_lengths, is_training,
                            deferred, "encoder_lstm", tp),
            state["encoder"], is_training)
        enc_out = L.gather_blocks(enc_out, tp, 2)
        keys_mem = A.prepare_memory(params["attention"], enc_out, tp)
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
    def postnet_residual(self, params, state, frames: torch.Tensor) -> torch.Tensor:
        """Postnet over decoder frames [N, T, M] (or a window of them):
        mel = frames + this residual (in the compute dtype)."""
        return M.postnet(self._cast(params["postnet"]), state["postnet"],
                         self._cast(frames))

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
        decoder_out = D.assemble_outputs(outs, cfg.num_mels)
        mel_outputs = decoder_out + self.postnet_residual(params, state,
                                                          decoder_out)
        expand_out = M.conv_and_lstm(params["expand"], state["expand"],
                                     self._expand_meta, mel_outputs, None)
        return {"mel_outputs": mel_outputs,
                "linear_outputs": L.dense(params["linear_proj"], expand_out),
                "alignments": D.assemble_alignments(aligns),
                "decoder_steps": steps}

    def forward_train(self, params, state, text_inputs: torch.Tensor,
                      input_lengths: torch.Tensor,
                      speaker_ids: Optional[torch.Tensor],
                      mel_targets: torch.Tensor, is_training: bool = True,
                      generator: Optional[torch.Generator] = None,
                      deferred: Optional[DF.Taps] = None):
        """Teacher-forced forward (``is_training`` and ``mel_targets`` of
        the JAX package's ``forward``): returns ``(outputs, new_bn_state)``
        with mel_outputs [N, T_out, M], linear_outputs [N, T_out, F],
        alignments [N, T_in, S] and, when the penalty is on,
        guided_attention. In training, dropout and scheduled sampling draw
        from ``generator``; with ``is_training=False`` (the holdout loss,
        the training previews) batch norm reads its running statistics.
        ``deferred`` (:meth:`deferred_zero_inputs`) defers the weight
        gradients of the products it names; :meth:`deferred_merge_grads`
        then completes autograd's gradient."""
        cfg = self.cfg
        n, t_in = text_inputs.shape
        tp = collectives.current_tp()
        # the policy's entry: float32 masters stay outside, and autograd
        # returns float32 gradients to them through the cast
        params = self._cast(params)
        mel_targets = self._cast(mel_targets)
        ctx, enc_state = self._encode(params, state, text_inputs,
                                      input_lengths, speaker_ids, is_training,
                                      deferred, tp)
        step = self._make_step(params, *ctx, is_training=is_training,
                               generator=generator, deferred=deferred, tp=tp)
        ss = float(cfg.get("scheduled_sampling_ratio", 0.0)) if is_training else 0.0
        outs, aligns = D.scan_teacher(
            step, self._decoder_carry0(n, t_in, text_inputs.device, tp),
            D.teacher_frames(mel_targets, cfg.outputs_per_step), ss, generator)
        decoder_out = D.assemble_outputs(outs, cfg.num_mels)
        alignments = D.assemble_alignments(aligns)
        residual, post_state = M.with_state(
            M.postnet(params["postnet"], state["postnet"], decoder_out,
                      is_training, tp), state["postnet"], is_training)
        mel_outputs = decoder_out + residual
        expand_out, expand_state = M.with_state(
            M.conv_and_lstm(params["expand"], state["expand"],
                            self._expand_meta, mel_outputs, None, is_training,
                            deferred, "expand_lstm", tp),
            state["expand"], is_training)
        outputs = {"mel_outputs": mel_outputs,
                   "linear_outputs": L.row_dense(params["linear_proj"],
                                                 expand_out, tp),
                   "alignments": alignments}
        guided = D.maybe_guided_attention(cfg, alignments, input_lengths,
                                          mel_targets, is_training)
        if guided is not None:
            outputs["guided_attention"] = guided
        return outputs, {"encoder": enc_state, "postnet": post_state,
                         "expand": expand_state}

    def loss(self, outputs, mel_targets, linear_targets):
        """(loss, metrics) in float32: mel L1 plus the linear L1 with a 2
        kHz priority band (see :func:`tacotron.tacotron_loss`)."""
        return tacotron_loss(self.cfg, outputs, mel_targets, linear_targets,
                             priority_hz=2000)
