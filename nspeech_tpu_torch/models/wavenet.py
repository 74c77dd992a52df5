"""WaveNet: gated dilated causal convolutions over mu-law codes.

Port of ``nspeech_tpu/models/wavenet.py``: the training forward and loss
(one-hot or scalar input), teacher-forced logits and the step-by-step
generator (one-hot input only, as in JAX). Parameters keep the JAX
package's tree: ``causal`` [fw, Q, R] (scalar input:
[initial_filter_width, 1, R]); per layer ``filter``/``gate`` [fw, R,
DC], ``dense`` [1, DC, R], ``skip`` [1, DC, S], optional
``gc_*``/``lc_*`` [1, C, DC] and biases; ``post1`` [1, S, S], ``post2``
[1, S, Q]; ``gc_embedding`` [cardinality, gc_channels].

:meth:`WaveNet.generate` and :meth:`WaveNet.generate_chunk` are the plain
versions of the CUDA sampler (``ops/cuda/wavenet_gen.py``): they run the
same per-sample recurrence one PyTorch op at a time from the same carried
state, and at temperature > 0 draw the sampler's Philox Gumbel noise, so
the two pick the same codes from the same logits.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from nspeech_tpu_torch.config import Config
from nspeech_tpu_torch.dsp.mulaw import mu_law_encode
from nspeech_tpu_torch.ops import policy as P
from nspeech_tpu_torch.ops.layers import acc_dot, glorot_uniform
from nspeech_tpu_torch.ops.philox import gumbel_noise
from nspeech_tpu_torch.utils.tree import named_leaves

Params = Dict[str, Any]


def calculate_receptive_field(filter_width: int, dilations, scalar_input: bool,
                              initial_filter_width: int) -> int:
    receptive_field = (filter_width - 1) * sum(dilations) + 1
    if scalar_input:
        receptive_field += initial_filter_width - 1
    else:
        receptive_field += filter_width - 1
    return receptive_field


def _conv_init(rng, shape) -> torch.Tensor:
    """Xavier-uniform for conv weights [W, Cin, Cout]."""
    return glorot_uniform(rng, shape, shape[0] * shape[1], shape[0] * shape[2])


class WaveNet:
    name = "wavenet"

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.dilations = [
            2 ** i for _ in range(cfg.dilations_depth)
            for i in range(cfg.dilations_length)
        ]
        self.filter_width = cfg.filter_width
        self.residual_channels = cfg.residual_channels
        self.dilation_channels = cfg.dilation_channels
        self.quantization_channels = cfg.quantization_channels
        self.skip_channels = cfg.skip_channels
        self.use_biases = bool(cfg.use_biases)
        self.scalar_input = bool(cfg.scalar_input)
        self.initial_filter_width = cfg.initial_filter_width
        self.gc_channels = cfg.gc_channels or 0
        self.gc_cardinality = cfg.gc_category_cardinality or 0
        self.lc_channels = cfg.lc_channels or 0
        self.receptive_field = calculate_receptive_field(
            self.filter_width, self.dilations, self.scalar_input,
            self.initial_filter_width)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def init(self, seed: int) -> Params:
        """Glorot-uniform weights drawn from ``numpy.random.default_rng(seed)``
        (CPU tensors; move them with ``ops.layers.tree_to``)."""
        rng = np.random.default_rng(seed)
        fw = self.filter_width
        R, DC, Q, S = (self.residual_channels, self.dilation_channels,
                       self.quantization_channels, self.skip_channels)
        params: Params = {}
        if self.gc_channels and self.gc_cardinality:
            if self.gc_cardinality == self.gc_channels:
                table = torch.eye(self.gc_cardinality)
            else:
                table = _conv_init(rng, (1, self.gc_cardinality,
                                         self.gc_channels))[0]
            params["gc_embedding"] = table
        if self.scalar_input:
            params["causal"] = _conv_init(rng, (self.initial_filter_width, 1, R))
        else:
            params["causal"] = _conv_init(rng, (fw, Q, R))
        layers = []
        for _ in self.dilations:
            lp = {
                "filter": _conv_init(rng, (fw, R, DC)),
                "gate": _conv_init(rng, (fw, R, DC)),
                "dense": _conv_init(rng, (1, DC, R)),
                "skip": _conv_init(rng, (1, DC, S)),
            }
            if self.gc_channels:
                lp["gc_filter"] = _conv_init(rng, (1, self.gc_channels, DC))
                lp["gc_gate"] = _conv_init(rng, (1, self.gc_channels, DC))
            if self.lc_channels:
                lp["lc_filter"] = _conv_init(rng, (1, self.lc_channels, DC))
                lp["lc_gate"] = _conv_init(rng, (1, self.lc_channels, DC))
            if self.use_biases:
                lp["filter_bias"] = torch.zeros(DC)
                lp["gate_bias"] = torch.zeros(DC)
                lp["dense_bias"] = torch.zeros(R)
                lp["skip_bias"] = torch.zeros(S)
            layers.append(lp)
        params["layers"] = layers
        params["post1"] = _conv_init(rng, (1, S, S))
        params["post2"] = _conv_init(rng, (1, S, Q))
        if self.use_biases:
            params["post1_bias"] = torch.zeros(S)
            params["post2_bias"] = torch.zeros(Q)
        return params

    # ------------------------------------------------------------------
    # Teacher-forced network
    # ------------------------------------------------------------------

    @staticmethod
    def _causal_conv(x: torch.Tensor, w: torch.Tensor, dilation: int):
        """VALID dilated causal conv, y_t = sum_k x_{t+k*d} @ W_k: shifted
        slice matmuls for width <= 4 (float32 accumulation, ``acc_dot``),
        else one ``conv1d`` (the scalar input's wide first conv), as the
        JAX package splits it."""
        fw = w.shape[0]
        if fw > 4:
            y = torch.nn.functional.conv1d(x.transpose(1, 2),
                                           w.permute(2, 1, 0), dilation=dilation)
            return y.transpose(1, 2)
        t_out = x.shape[1] - dilation * (fw - 1)
        out = None
        for k in range(fw):
            term = acc_dot(x[:, k * dilation: k * dilation + t_out], w[k])
            out = term if out is None else out + term
        return out

    def _network(self, params: Params, x: torch.Tensor,
                 gc: Optional[torch.Tensor], lc: Optional[torch.Tensor]):
        """Network input [N, T_in, C_in] -> logits [N, T_in - RF + 1, Q];
        ``lc`` [N, T_in, lc_channels] is aligned with ``x``."""
        x = self._causal_conv(x, params["causal"], 1)
        shrink = (self.initial_filter_width if self.scalar_input
                  else self.filter_width) - 1
        return self._network_body(params, x, gc, lc, shrink)

    def _network_body(self, params: Params, x: torch.Tensor,
                      gc: Optional[torch.Tensor], lc: Optional[torch.Tensor],
                      shrink: int) -> torch.Tensor:
        """Dilated stack + skip reduction + post network. ``x`` is the
        output of the initial causal conv; ``shrink`` is how many leading
        samples that conv consumed (aligns ``lc``)."""
        fw = self.filter_width
        output_width = x.shape[1] - sum(self.dilations) * (fw - 1)
        dc = self.dilation_channels
        skip_outs = []
        current = x
        for lp, dilation in zip(params["layers"], self.dilations):
            w_fg = torch.cat([lp["filter"], lp["gate"]], dim=2)
            conv_fg = self._causal_conv(current, w_fg, dilation)
            shrink += dilation * (fw - 1)
            if gc is not None:
                w_gc = torch.cat([lp["gc_filter"][0], lp["gc_gate"][0]], dim=1)
                conv_fg = conv_fg + (gc @ w_gc)[:, None, :]
            if lc is not None:
                w_lc = torch.cat([lp["lc_filter"][0], lp["lc_gate"][0]], dim=1)
                conv_fg = conv_fg + lc[:, shrink:, :] @ w_lc
            if self.use_biases:
                conv_fg = conv_fg + torch.cat([lp["filter_bias"],
                                               lp["gate_bias"]])
            out = torch.tanh(conv_fg[..., :dc]) * torch.sigmoid(conv_fg[..., dc:])
            transformed = out @ lp["dense"][0]
            if self.use_biases:
                transformed = transformed + lp["dense_bias"]
            skip_outs.append(out[:, -output_width:, :])
            current = current[:, -transformed.shape[1]:, :] + transformed
        # The skip sum as ONE product over the layers stacked on the
        # contraction axis, sum_l out_l @ W_l = [out_1 .. out_L] @ [W_1; ..;
        # W_L], as JAX computes it: a per-layer sum would read and write
        # the [N, T, S] accumulator (168 MB at the training window) once
        # per layer, and its gradient as often.
        skips = acc_dot(torch.cat(skip_outs, dim=-1),
                        torch.cat([lp["skip"][0] for lp in params["layers"]]))
        if self.use_biases:
            skips = skips + sum(lp["skip_bias"] for lp in params["layers"])
        h = torch.relu(skips) @ params["post1"][0]
        if self.use_biases:
            h = h + params["post1_bias"]
        logits = torch.relu(h) @ params["post2"][0]
        if self.use_biases:
            logits = logits + params["post2_bias"]
        return logits

    def check_gc_ids(self, params: Params, gc_ids) -> None:
        """Raise ValueError on the host for an id outside the gc table (on
        the card the index would be a device-side assert; JAX's
        ``jnp.take`` returns NaN rows). Reads the ids on the host."""
        table = params["gc_embedding"]
        ids = torch.as_tensor(gc_ids, dtype=torch.int64)
        if ids.numel() and not 0 <= int(ids.min()) <= int(ids.max()) < table.shape[0]:
            raise ValueError(f"gc ids {ids.tolist()} outside [0, {table.shape[0]})")

    def _embed_gc(self, params: Params, gc_ids) -> Optional[torch.Tensor]:
        """Rows of the gc table, the ids checked by :meth:`check_gc_ids`
        except inside a CUDA graph's capture, which cannot read them (the
        graphed train step checks them before each replay)."""
        if gc_ids is None or not self.gc_channels:
            return None
        table = params["gc_embedding"]
        ids = torch.as_tensor(gc_ids, dtype=torch.int64)
        if not (ids.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.check_gc_ids(params, ids)
        return table[ids.to(table.device)]

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def forward_train(self, params: Params, audio: torch.Tensor,
                      gc_ids: Optional[torch.Tensor] = None,
                      lc: Optional[torch.Tensor] = None):
        """Waveform windows [N, T] (with speaker ids [N] and per-sample
        ``lc`` [N, T, lc_channels]) -> (logits [N, T - RF, Q], target codes
        [N, T - RF]): sample t+1's code is predicted from samples <= t.
        The parameters and ``lc`` are cast to ``compute_dtype`` at entry
        (``ops/policy.py``); the logits come out in it."""
        dtype = P.compute_dtype(self.cfg)
        params = P.entry_cast(params, dtype)
        lc = P.entry_cast(lc, dtype)
        encoded = mu_law_encode(audio, self.quantization_channels)
        lc_in = lc[:, :-1, :] if lc is not None else None
        gc = self._embed_gc(params, gc_ids)
        if self.scalar_input:
            logits = self._network(params, audio[:, :-1, None].to(dtype),
                                   gc, lc_in)
        else:
            logits = self._network_embedded(params, encoded[:, :-1], gc, lc_in)
        return logits, encoded[:, self.receptive_field:]

    def loss(self, logits: torch.Tensor, targets: torch.Tensor,
             params: Optional[Params] = None,
             l2_strength: Optional[float] = None):
        """(loss, metrics): the mean cross-entropy (``loss``), in float32 or
        wider; with ``l2_strength`` and ``params`` plus ``l2_strength``
        times half the sum of squares of every leaf whose path does not
        name ``bias`` (``l2_loss``, ``total_loss``)."""
        q = logits.shape[-1]
        loss = torch.nn.functional.cross_entropy(
            logits.to(torch.promote_types(logits.dtype, torch.float32)).reshape(-1, q),
            targets.reshape(-1).to(torch.int64))
        metrics = {"loss": loss}
        if l2_strength and params is not None:
            l2 = sum(torch.sum(torch.square(w))
                     for path, w in named_leaves(params) if "bias" not in path) * 0.5
            metrics["l2_loss"] = l2
            loss = loss + l2_strength * l2
            metrics["total_loss"] = loss
        return loss, metrics

    def predict_logits(self, params: Params, codes: torch.Tensor, gc_ids=None,
                       lc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-window scoring: mu-law codes [N, T] -> logits
        [N, T - RF + 1, Q] through the one-hot input."""
        one_hot = torch.nn.functional.one_hot(
            codes.to(torch.int64), self.quantization_channels).to(torch.float32)
        return self._network(params, one_hot, self._embed_gc(params, gc_ids), lc)

    def _network_embedded(self, params: Params, codes: torch.Tensor,
                          gc, lc) -> torch.Tensor:
        """Codes [N, T] -> logits [N, T - RF + 1, Q]: the width-fw one-hot
        causal conv is fw gathers from the same kernel."""
        fw = self.filter_width
        w = params["causal"]                        # [fw, Q, R]
        codes = codes.to(torch.int64)
        t_out = codes.shape[1] - fw + 1
        x = sum(w[k][codes[:, k: k + t_out]] for k in range(fw))
        return self._network_body(params, x, gc, lc, shrink=fw - 1)

    # ------------------------------------------------------------------
    # Step-by-step generation with ring buffers
    # ------------------------------------------------------------------

    def _gen_step(self, params: Params, code_in: torch.Tensor,
                  prev_code: torch.Tensor, t: int, rings,
                  gc: Optional[torch.Tensor], lc_t: Optional[torch.Tensor]):
        """One step at absolute sample ``t`` on input codes [N].
        ``prev_code`` [N] is the previous step's input, -1 where the causal
        conv's past tap is zero (at t=0). Updates ``rings`` (per layer
        [d, N, R]) in place and returns the logits [N, Q]."""
        w = params["causal"]
        current = w[1][code_in]
        current = torch.where((prev_code >= 0)[:, None],
                              w[0][prev_code.clamp(min=0)] + current, current)
        skips = None
        for lp, dilation, ring in zip(params["layers"], self.dilations, rings):
            slot = t % dilation
            state = ring[slot].clone()
            out_f = state @ lp["filter"][0] + current @ lp["filter"][1]
            out_g = state @ lp["gate"][0] + current @ lp["gate"][1]
            if gc is not None:
                out_f = out_f + gc @ lp["gc_filter"][0]
                out_g = out_g + gc @ lp["gc_gate"][0]
            if lc_t is not None:
                out_f = out_f + lc_t @ lp["lc_filter"][0]
                out_g = out_g + lc_t @ lp["lc_gate"][0]
            if self.use_biases:
                out_f = out_f + lp["filter_bias"]
                out_g = out_g + lp["gate_bias"]
            out = torch.tanh(out_f) * torch.sigmoid(out_g)
            transformed = out @ lp["dense"][0]
            skip = out @ lp["skip"][0]
            if self.use_biases:
                transformed = transformed + lp["dense_bias"]
                skip = skip + lp["skip_bias"]
            skips = skip if skips is None else skips + skip
            ring[slot] = current
            current = current + transformed
        h = torch.relu(skips) @ params["post1"][0]
        if self.use_biases:
            h = h + params["post1_bias"]
        logits = torch.relu(h) @ params["post2"][0]
        if self.use_biases:
            logits = logits + params["post2_bias"]
        return logits

    def generate_carry0(self, batch: int = 1, device="cpu"):
        """Initial carry ``(t0, code [N], prev [N], rings [N, sum(d), R])``
        of :meth:`generate_chunk`: sample 0, the mid-scale silence code as
        the first input, no previous input (-1), zeroed rings. The rings
        are the CUDA sampler's layout: layer l's ring is rows
        ``sum(d[:l]) .. + d[l]``, its slot for sample t is ``t mod d[l]``."""
        Q, R = self.quantization_channels, self.residual_channels
        return (0,
                torch.full((batch,), Q // 2, dtype=torch.int32, device=device),
                torch.full((batch,), -1, dtype=torch.int32, device=device),
                torch.zeros(batch, sum(self.dilations), R, device=device))

    def _check_generate(self, lc):
        if self.scalar_input or self.filter_width != 2:
            raise NotImplementedError(
                "Fast generation supports filter_width=2 one-hot models")
        if self.lc_channels and lc is None:
            raise ValueError(
                "model has lc_channels=%d; pass lc= (per-sample local "
                "conditioning) to generate" % self.lc_channels)
        if lc is not None and not self.lc_channels:
            raise ValueError("lc given but model has lc_channels=0")

    def sample(self, params: Params, carry, n_steps: int, seed: int, gc,
               lc: Optional[torch.Tensor], temperature: float,
               forced: Optional[torch.Tensor] = None,
               logits_all: Optional[list] = None):
        """The sampling loop of :meth:`generate` and :meth:`generate_chunk`:
        ``n_steps`` steps from ``carry`` (left as it was) with the embedded
        speakers ``gc`` and per-step ``lc`` [N, T, M] (zero past T). Step i
        takes ``forced[:, i]`` as its input while i < forced's length (so
        a check can feed another sampler's codes), else the code sampled
        at the step before; its logits are appended to ``logits_all``.
        Returns (codes [N, n_steps] int64, new carry)."""
        t0, code, prev, rings = carry
        dev = rings.device
        batch, Q = rings.shape[0], self.quantization_channels
        if lc is not None:
            lc = torch.as_tensor(lc, dtype=torch.float32, device=dev)
            if lc.shape[1] < n_steps:
                lc = torch.nn.functional.pad(lc, (0, 0, 0, n_steps - lc.shape[1]))
        rings = rings.clone()
        views, row = [], 0
        for d in self.dilations:                # per layer [d, N, R] views
            views.append(rings[:, row:row + d].transpose(0, 1))
            row += d
        code, prev = code.to(torch.int64), prev.to(torch.int64)
        n_forced = 0 if forced is None else forced.shape[1]
        samples = []
        for i in range(n_steps):
            t = t0 + i
            code_in = forced[:, i] if i < n_forced else code
            logits = self._gen_step(params, code_in, prev, t, views, gc,
                                    None if lc is None else lc[:, i])
            prev = code_in
            if temperature <= 0.0:
                code = torch.argmax(logits, dim=-1)
            else:
                g = gumbel_noise(seed, torch.tensor([t], device=dev),
                                 batch, Q)[0]
                code = torch.argmax(logits * (1.0 / temperature) + g, dim=-1)
            samples.append(code)
            if logits_all is not None:
                logits_all.append(logits)
        out = torch.stack(samples, dim=1)
        return out, (t0 + n_steps, code.to(torch.int32),
                     prev.to(torch.int32), rings)

    def generate_chunk(self, params: Params, carry, n_samples: int,
                       seed: int = 0, gc_ids=None,
                       lc: Optional[torch.Tensor] = None,   # [N, >= n_samples, M]
                       temperature: float = 1.0):
        """Run ``n_samples`` sampling steps from ``carry`` (see
        :meth:`generate_carry0`; it is left as it was) and return
        ``(codes [N, n_samples] int32, new carry)``: the streaming form of
        :meth:`generate`. Noise is keyed by ``seed`` at the absolute
        sample index, so chained chunks give the codes of one
        :meth:`generate` call at every temperature."""
        self._check_generate(lc)
        codes, carry = self.sample(params, carry, n_samples, seed,
                                   self._embed_gc(params, gc_ids), lc,
                                   temperature)
        return codes.to(torch.int32), carry

    def generate(
        self,
        params: Params,
        n_samples: int,
        seed: int = 0,
        batch: int = 1,
        gc_ids=None,
        lc: Optional[torch.Tensor] = None,          # [N, n_samples, M]
        seed_codes: Optional[torch.Tensor] = None,  # [N, T_seed] priming
        temperature: float = 1.0,
        return_logits: bool = False,
        include_prime: bool = False,
    ):
        """Autoregressive sampling on the device that holds ``params``.

        Returns mu-law codes [N, n_samples] int32 (and the per-step logits
        with ``return_logits``). Temperature <= 0 is argmax with the
        lowest-index tie-break; above 0 it is Gumbel-max over
        ``logits / T`` with the sampler's Philox noise keyed by ``seed``.
        Priming feeds ``seed_codes`` as the inputs of the first steps; the
        emission of step t is the prediction for time t+1, so the first
        free sample is step ``prime_len - 1``."""
        self._check_generate(lc)
        dev = params["causal"].device
        prime_len = 0 if seed_codes is None else int(seed_codes.shape[1])
        total = prime_len + n_samples
        forced = None
        if seed_codes is not None:
            forced = torch.as_tensor(seed_codes, device=dev).to(torch.int64)
        logits_all = [] if return_logits else None
        codes, _ = self.sample(params, self.generate_carry0(batch, dev),
                               total, seed, self._embed_gc(params, gc_ids),
                               lc, temperature, forced, logits_all)
        skip = 0 if include_prime else max(prime_len - 1, 0)
        end = None if include_prime else skip + n_samples
        out = codes[:, skip:end].to(torch.int32)
        if return_logits:
            return out, torch.stack(logits_all, dim=1)[:, skip:end]
        return out
