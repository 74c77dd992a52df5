"""Tacotron-1 inference: character embedding -> encoder prenet -> encoder
CBHG -> attention decoder (GRU attention cell, output projection, two
residual GRUs, r frames per step) -> post-CBHG -> linear spectrogram.

Port of the eval path of ``nspeech_tpu/models/tacotron.py``. The decoder
prenet reads [input frame; previous attention context] (the reference's
composition, not the paper's). The decoder frames are the mel: there is
no postnet, so the model has no ``postnet_residual`` and the stream needs
no postnet halo. The streaming hooks (:meth:`Tacotron1.attention_context`,
:meth:`Tacotron1.make_eval_step`) are the pieces :meth:`Tacotron1.forward`
is built from, as in :mod:`nspeech_tpu_torch.models.tacotron2`.
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

    def _make_step(self, params, keys_mem, values, mask, spk):
        cfg = self.cfg
        att_type = cfg.attention_type
        win_fwd = int(cfg.get("attention_win_fwd", 0))
        win_back = int(cfg.get("attention_win_back", 1))
        spk_pre = (None if spk is None
                   else L.dense(params["spk_prenet"], spk, L.softsign))

        def step(carry, x):
            h1, context, align, h2, h3 = carry
            pre = L.prenet(params["decoder_prenet"],
                           torch.cat([x, context], dim=-1))
            if spk_pre is not None:
                pre = torch.cat([pre, spk_pre], dim=-1)
            h1 = L.gru_cell(params["attn_gru"], pre, h1)
            m = A.window_mask(align, mask, win_back, win_fwd) if win_fwd > 0 else mask
            context, align = A.attention_step(params["attention"], att_type, h1,
                                              align, keys_mem, values, m)
            proj = L.dense(params["out_proj"], torch.cat([h1, context], dim=-1))
            g2 = L.gru_cell(params["gru2"], proj, h2)
            o2 = proj + g2
            g3 = L.gru_cell(params["gru3"], o2, h3)
            out = L.dense(params["frame_proj"], o2 + g3)
            return (h1, context, align, g2, g3), (out, align)

        return step

    def _decoder_carry0(self, batch: int, t_in: int, device):
        cfg = self.cfg
        return (torch.zeros(batch, cfg.attention_dim, device=device),
                torch.zeros(batch, self._memory_dim, device=device),
                A.initial_alignments(cfg.attention_type, batch, t_in, device),
                torch.zeros(batch, cfg.decoder_dim, device=device),
                torch.zeros(batch, cfg.decoder_dim, device=device))

    # -- streaming hooks ------------------------------------------------------

    @torch.no_grad()
    def attention_context(self, params, state, text_inputs: torch.Tensor,
                          input_lengths: torch.Tensor,
                          speaker_ids: Optional[torch.Tensor] = None):
        """Encoder side of inference: ``(step_ctx, decoder carry0)`` for
        :meth:`make_eval_step` and the decoder's chunked decode."""
        n, t_in = text_inputs.shape
        dev = text_inputs.device
        spk = None
        if self.multi_speaker:
            spk = params["speaker_embed"]["table"][speaker_ids]
        pre = L.prenet(params["encoder_prenet"],
                       L.embedding(params["embedding"], text_inputs))
        enc_out = M.cbhg(params["encoder_cbhg"], state["encoder_cbhg"],
                         self._enc_meta, pre, input_lengths, spk)
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
        mel_outputs = D.assemble_outputs(outs, cfg.num_mels)
        post_out = M.cbhg(params["post_cbhg"], state["post_cbhg"],
                          self._post_meta, mel_outputs, None, None)
        return {"mel_outputs": mel_outputs,
                "linear_outputs": L.dense(params["linear_proj"], post_out),
                "alignments": D.assemble_alignments(aligns),
                "decoder_steps": steps}
