"""Tacotron-2 inference: conv+BiLSTM encoder, location-sensitive attention,
LSTM decoder with early stop, postnet residual, conv+BiLSTM expand network
to linear spectra.

Port of the eval path of ``nspeech_tpu/models/tacotron2.py``. The decoder
step is prenet -> attention LSTM -> location-sensitive attention -> 2 LSTMs
-> r-frame projection, run by :func:`decoder.scan_autoregressive`. The
streaming hooks (:meth:`Tacotron2.attention_context`,
:meth:`Tacotron2.make_eval_step`, :meth:`Tacotron2.postnet_residual`) are
the pieces :meth:`Tacotron2.forward` is built from, so the one-shot path
and the stream share one encoder, one decoder step and one postnet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nspeech_tpu_torch.config import Config
from nspeech_tpu_torch.models import attention as A
from nspeech_tpu_torch.models import decoder as D
from nspeech_tpu_torch.models import modules as M
from nspeech_tpu_torch.ops import layers as L
from nspeech_tpu_torch.text.symbols import symbols


class Tacotron2:
    name = "taco2"

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
        params["attention"] = A.init_attention(
            rng, cfg.attention_dim, self._memory_dim, cfg.attention_dim)
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

    def _make_step(self, params, keys_mem, values, mask, spk):
        cfg = self.cfg
        win_fwd = int(cfg.get("attention_win_fwd", 0))
        win_back = int(cfg.get("attention_win_back", 1))
        spk_pre = (None if spk is None
                   else L.dense(params["spk_prenet"], spk, L.softsign))

        def step(carry, x):
            (c1, h1), context, align, (c2, h2), (c3, h3) = carry
            pre = L.prenet(params["decoder_prenet"],
                           torch.cat([x, context], dim=-1))
            if spk_pre is not None:
                pre = torch.cat([pre, spk_pre], dim=-1)
            out1, (c1, h1) = L.lstm_cell(params["attn_lstm"], pre, (c1, h1))
            m = A.window_mask(align, mask, win_back, win_fwd) if win_fwd > 0 else mask
            context, align = A.attention_step(params["attention"], out1, align,
                                              keys_mem, values, m)
            out2, (c2, h2) = L.lstm_cell(params["lstm1"],
                                         torch.cat([out1, context], dim=-1),
                                         (c2, h2))
            out3, (c3, h3) = L.lstm_cell(params["lstm2"], out2, (c3, h3))
            out = L.dense(params["frame_proj"], out3)
            return ((c1, h1), context, align, (c2, h2), (c3, h3)), (out, align)

        return step

    def _decoder_carry0(self, batch: int, t_in: int, device):
        cfg = self.cfg

        def z(*shape):
            return torch.zeros(*shape, device=device)

        return ((z(batch, cfg.attention_dim), z(batch, cfg.attention_dim)),
                z(batch, self._memory_dim),
                z(batch, t_in),
                (z(batch, cfg.decoder_lstm_units), z(batch, cfg.decoder_lstm_units)),
                (z(batch, cfg.decoder_lstm_units), z(batch, cfg.decoder_lstm_units)))

    # -- streaming hooks ------------------------------------------------------

    @torch.no_grad()
    def attention_context(self, params, state, text_inputs: torch.Tensor,
                          input_lengths: torch.Tensor,
                          speaker_ids: Optional[torch.Tensor] = None):
        """Encoder side of inference: ``(step_ctx, decoder carry0)`` for
        :meth:`make_eval_step` and the decoder's chunked decode."""
        n, t_in = text_inputs.shape
        dev = text_inputs.device
        embedded = L.embedding(params["embedding"], text_inputs)
        spk = None
        if self.multi_speaker:
            spk = params["speaker_embed"]["table"][speaker_ids]
        enc_out = M.conv_and_lstm(params["encoder"], state["encoder"],
                                  self._enc_meta, embedded, input_lengths)
        keys_mem = A.prepare_memory(params["attention"], enc_out)
        # max(len, 1) keeps the softmax finite for length-0 padding rows
        mask = (torch.arange(t_in, device=dev)[None, :]
                < torch.clamp(input_lengths, min=1)[:, None])
        return ((keys_mem, enc_out, mask, spk),
                self._decoder_carry0(n, t_in, dev))

    def make_eval_step(self, params, step_ctx):
        """The decoder step ``(carry, x) -> (carry, (out, align))`` over
        :meth:`attention_context`'s ``step_ctx``."""
        keys_mem, enc_out, mask, spk = step_ctx
        return self._make_step(params, keys_mem, enc_out, mask, spk)

    @torch.no_grad()
    def postnet_residual(self, params, state, frames: torch.Tensor) -> torch.Tensor:
        """Postnet over decoder frames [N, T, M] (or a window of them):
        mel = frames + this residual."""
        return M.postnet(params["postnet"], state["postnet"], frames)

    @torch.no_grad()
    def forward(self, params, state, text_inputs: torch.Tensor,
                input_lengths: torch.Tensor,
                speaker_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Inference forward: text ids [N, T_in] -> mel_outputs [N, T, M],
        linear_outputs [N, T, F], alignments [N, T_in, S], decoder_steps [N].
        Rows of length 0 are padding: finished from the start."""
        cfg = self.cfg
        ctx, carry0 = self.attention_context(params, state, text_inputs,
                                             input_lengths, speaker_ids)
        outs, aligns, steps = D.scan_autoregressive(
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
