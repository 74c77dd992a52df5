"""Location-sensitive attention for the Tacotron-2 decoder.

Port of the ``location_sensitive`` mechanism of
``nspeech_tpu/models/attention.py``: Bahdanau energy over the projected
memory and query, plus features of the previous alignment (a bias-free
Conv1D 7x1 -> 20 filters, then a bias-free Dense to the attention width).
The other five mechanisms (Tacotron-1's) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nspeech_tpu_torch.ops.layers import (Params, conv1d, dense, glorot_uniform,
                                          init_conv1d, init_dense)

_LOCATION_FILTERS = 20
_LOCATION_KERNEL = 7


def init_attention(rng, num_units: int, memory_dim: int, query_dim: int) -> Params:
    return {
        "memory_layer": init_dense(rng, memory_dim, num_units, use_bias=False),
        "query_layer": init_dense(rng, query_dim, num_units, use_bias=False),
        "v": glorot_uniform(rng, (num_units,), num_units, 1),
        "location_conv": init_conv1d(rng, _LOCATION_KERNEL, 1,
                                     _LOCATION_FILTERS, use_bias=False),
        "location_layer": init_dense(rng, _LOCATION_FILTERS, num_units,
                                     use_bias=False),
    }


def prepare_memory(params: Params, memory: torch.Tensor) -> torch.Tensor:
    """[N, T_in, memory_dim] -> projected keys [N, T_in, num_units]."""
    return dense(params["memory_layer"], memory)


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
    if mask is not None:
        score = score.masked_fill(~mask, float("-inf"))
    return torch.softmax(score, dim=-1)


def attention_step(params: Params, query: torch.Tensor,
                   prev_alignments: torch.Tensor, keys: torch.Tensor,
                   values: torch.Tensor, mask: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention read. Returns (context [N, memory_dim], alignments
    [N, T_in])."""
    q = dense(params["query_layer"], query)[:, None, :]          # [N, 1, U]
    f = conv1d(params["location_conv"], prev_alignments[:, :, None])
    loc = dense(params["location_layer"], f)                      # [N, T_in, U]
    energy = torch.tanh(keys + q + loc)
    alignments = _masked_softmax(energy @ params["v"], mask)
    context = torch.bmm(alignments[:, None, :], values)[:, 0]
    return context, alignments
