"""Attention mechanisms for the Tacotron decoders.

Port of ``nspeech_tpu/models/attention.py``: the six mechanisms of
``ATTENTION_TYPES``. Tacotron-2 uses ``location_sensitive`` (Bahdanau
energy plus features of the previous alignment: a bias-free Conv1D 7x1 ->
20 filters, then a bias-free Dense to the attention width); Tacotron-1
takes any of them from its ``attention_type`` hparam. The previous
alignment is the state carried between decoder steps (read by
``location_sensitive`` and ``bah_mon``).

In a tensor-parallel step (``tp``, Tacotron-2's ``location_sensitive``)
the memory, query and location projections and ``v`` hold this model
rank's attention dims: the rank computes its dims of the energy, the
score is the sum of the ranks' partial dots, and the softmax, the
alignments and the context are whole on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nspeech_tpu_torch.ops.layers import (Params, column_dense, conv1d,
                                          glorot_uniform, init_conv1d, init_dense)
from nspeech_tpu_torch.ops.policy import upcast
from nspeech_tpu_torch.parallel import collectives

ATTENTION_TYPES = (
    "bah", "bah_mon", "bah_norm", "luong", "luong_scaled", "location_sensitive",
)

_LOCATION_FILTERS = 20
_LOCATION_KERNEL = 7


def init_attention(rng, attention_type: str, num_units: int, memory_dim: int,
                   query_dim: int) -> Params:
    if attention_type not in ATTENTION_TYPES:
        raise ValueError(f"Unknown attention type {attention_type!r}")
    p: Params = {"memory_layer": init_dense(rng, memory_dim, num_units,
                                            use_bias=False)}
    if attention_type in ("bah", "bah_mon", "bah_norm", "location_sensitive"):
        p["query_layer"] = init_dense(rng, query_dim, num_units, use_bias=False)
        p["v"] = glorot_uniform(rng, (num_units,), num_units, 1)
    if attention_type == "bah_norm":
        # weight-normalized score g * v / |v| with an inner bias b
        p["g"] = torch.tensor((1.0 / num_units) ** 0.5)
        p["b"] = torch.zeros(num_units)
    if attention_type == "bah_mon":
        p["score_bias"] = torch.tensor(0.0)
    if attention_type == "luong_scaled":
        p["g"] = torch.tensor(1.0)
    if attention_type == "location_sensitive":
        p["location_conv"] = init_conv1d(rng, _LOCATION_KERNEL, 1,
                                         _LOCATION_FILTERS, use_bias=False)
        p["location_layer"] = init_dense(rng, _LOCATION_FILTERS, num_units,
                                         use_bias=False)
    return p


def prepare_memory(params: Params, memory: torch.Tensor, tp=None) -> torch.Tensor:
    """[N, T_in, memory_dim] -> projected keys [N, T_in, num_units] (with
    ``tp``, this model rank's units)."""
    return column_dense(params["memory_layer"], memory, tp)


def initial_alignments(attention_type: str, batch: int, t_in: int,
                       device, dtype: torch.dtype = None) -> torch.Tensor:
    """The decoder's first previous alignment (in the compute dtype):
    monotonic attention starts on position 0, the others from zeros."""
    a = torch.zeros(batch, t_in, device=device, dtype=dtype)
    if attention_type == "bah_mon":
        a[:, 0] = 1.0
    return a


def window_mask(prev_alignments: torch.Tensor, mask: Optional[torch.Tensor],
                back: int, fwd: int) -> torch.Tensor:
    """Restrict attention to [p - back, p + fwd] around the previously
    attended position p = argmax(prev_alignments) (serving only)."""
    p = torch.argmax(prev_alignments, dim=-1)[:, None]
    idx = torch.arange(prev_alignments.shape[-1],
                       device=prev_alignments.device)[None, :]
    win = (idx >= p - back) & (idx <= p + fwd)
    return win if mask is None else (win & mask)


def _masked_softmax(score: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the inputs, normalized in float32 under the bf16
    policy and returned in the score's dtype."""
    s = upcast(score)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1).to(score.dtype)


def _monotonic_alignments(p_choose: torch.Tensor,
                          previous: torch.Tensor) -> torch.Tensor:
    """Raffel et al.'s parallel monotonic update: the clipped exclusive
    cumprod of (1 - p), in float32 (its clipping floors sit far below
    bf16's resolution), returned in the compute dtype."""
    out_dtype = previous.dtype
    p_choose, previous = upcast(p_choose), upcast(previous)
    cumprod_1mp = (torch.cumprod(1.0 - p_choose, dim=-1)
                   / torch.clamp(1.0 - p_choose, 1e-10, 1.0))
    cumprod_1mp = torch.clamp(cumprod_1mp, 1e-10, 1.0)
    return (p_choose * cumprod_1mp
            * torch.cumsum(previous / cumprod_1mp, dim=-1)).to(out_dtype)


def attention_step(params: Params, attention_type: str, query: torch.Tensor,
                   prev_alignments: torch.Tensor, keys: torch.Tensor,
                   values: torch.Tensor, mask: Optional[torch.Tensor],
                   tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention read. Returns (context [N, memory_dim], alignments
    [N, T_in]). ``tp`` (``location_sensitive`` only): ``keys`` are this
    model rank's units of :func:`prepare_memory`."""
    if attention_type in ("luong", "luong_scaled"):
        score = torch.einsum("nu,ntu->nt", query, keys)
        if attention_type == "luong_scaled":
            score = params["g"] * score
        alignments = _masked_softmax(score, mask)
    else:
        q = column_dense(params["query_layer"], query, tp)[:, None, :]  # [N, 1, U]
        if attention_type == "location_sensitive":
            f = conv1d(params["location_conv"], prev_alignments[:, :, None])
            energy = torch.tanh(keys + q + column_dense(params["location_layer"],
                                                        f, tp))
        elif attention_type == "bah_norm":
            energy = torch.tanh(keys + q + params["b"])
        else:
            energy = torch.tanh(keys + q)
        if attention_type == "bah_norm":
            v = params["g"] * (params["v"] / torch.linalg.vector_norm(params["v"]))
        else:
            v = params["v"]
        score = energy @ v
        if tp is not None:
            score = collectives.reduce_from_model(score, tp)
        if attention_type == "bah_mon":
            score = score + params["score_bias"]
            if mask is not None:
                # -inf before the sigmoid: a masked position is chosen
                # with probability exactly 0
                score = score.masked_fill(~mask, float("-inf"))
            alignments = _monotonic_alignments(torch.sigmoid(score),
                                               prev_alignments)
        else:
            alignments = _masked_softmax(score, mask)
    context = torch.bmm(alignments[:, None, :], values)[:, 0]
    return context, alignments
