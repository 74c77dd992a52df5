"""Neural-net building blocks as functions over parameter dicts (inference).

Port of the inference subset of ``nspeech_tpu/ops/layers.py``. Parameters
keep the JAX package's names, shapes and layouts (a dense kernel is
[in, out], a conv kernel [width, in, out], an LSTM kernel one [x, h] ->
4*units matrix with gates in (i, g, f, o) order), so bridged weights are
used as they are. Initializers draw from a ``numpy.random.Generator``
with the same distributions as the JAX package (glorot-uniform kernels,
truncated-normal embeddings).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, object]

BN_EPS = 1e-3


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def glorot_uniform(rng: np.random.Generator, shape, fan_in, fan_out) -> torch.Tensor:
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.from_numpy(
        rng.uniform(-limit, limit, size=shape).astype(np.float32))


def truncated_normal(rng: np.random.Generator, shape, stddev) -> torch.Tensor:
    """Normal(0, stddev) truncated to two standard deviations."""
    x = rng.standard_normal(size=shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(size=int(bad.sum()))
        bad = np.abs(x) > 2.0
    return torch.from_numpy((stddev * x).astype(np.float32))


def init_dense(rng, in_dim: int, out_dim: int, use_bias: bool = True) -> Params:
    p = {"kernel": glorot_uniform(rng, (in_dim, out_dim), in_dim, out_dim)}
    if use_bias:
        p["bias"] = torch.zeros(out_dim)
    return p


def init_embedding(rng, vocab_size: int, dim: int, stddev: float = 0.01) -> Params:
    return {"table": truncated_normal(rng, (vocab_size, dim), stddev)}


def init_conv1d(rng, width: int, in_ch: int, out_ch: int,
                use_bias: bool = True) -> Params:
    p = {"kernel": glorot_uniform(rng, (width, in_ch, out_ch),
                                  width * in_ch, width * out_ch)}
    if use_bias:
        p["bias"] = torch.zeros(out_ch)
    return p


def init_batch_norm(dim: int) -> Tuple[Params, Params]:
    return ({"scale": torch.ones(dim), "offset": torch.zeros(dim)},
            {"mean": torch.zeros(dim), "var": torch.ones(dim)})


def init_conv_bn(rng, width: int, in_ch: int, out_ch: int) -> Tuple[Params, Params]:
    bn_p, bn_s = init_batch_norm(out_ch)
    return ({"conv": init_conv1d(rng, width, in_ch, out_ch), "bn": bn_p},
            {"bn": bn_s})


def init_prenet(rng, in_dim: int, layer_sizes: Sequence[int]) -> Params:
    layers = []
    for size in layer_sizes:
        layers.append(init_dense(rng, in_dim, size))
        in_dim = size
    return {"layers": layers}


def init_lstm(rng, in_dim: int, units: int) -> Params:
    return {"kernel": glorot_uniform(rng, (in_dim + units, 4 * units),
                                     in_dim + units, 4 * units),
            "bias": torch.zeros(4 * units)}


def tree_to(tree, device):
    """Move every tensor of a nested dict/list tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + x.abs())


def dense(params: Params, x: torch.Tensor, activation=None) -> torch.Tensor:
    y = x @ params["kernel"]
    if "bias" in params:
        y = y + params["bias"]
    return activation(y) if activation is not None else y


def embedding(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def conv1d(params: Params, x: torch.Tensor) -> torch.Tensor:
    """'SAME' 1-D convolution: x [N, T, C] -> [N, T, C_out]."""
    w = params["kernel"]                       # [W, Cin, Cout]
    width = w.shape[0]
    left = (width - 1) // 2
    xt = F.pad(x.transpose(1, 2), (left, width - 1 - left))
    y = F.conv1d(xt, w.permute(2, 1, 0), params.get("bias"))
    return y.transpose(1, 2)


def batch_norm(params: Params, state: Params, x: torch.Tensor) -> torch.Tensor:
    """Inference batch norm over the last axis with running statistics."""
    inv = torch.rsqrt(state["var"] + BN_EPS) * params["scale"]
    return (x - state["mean"]) * inv + params["offset"]


def conv_bn(params: Params, state: Params, x: torch.Tensor,
            activation) -> torch.Tensor:
    """conv -> activation -> batch norm (the reference's order)."""
    y = conv1d(params["conv"], x)
    if activation is not None:
        y = activation(y)
    return batch_norm(params["bn"], state["bn"], y)


def prenet(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Stacked dense+relu (dropout is a training-time op)."""
    for layer in params["layers"]:
        x = dense(layer, x, torch.relu)
    return x


def _lstm_gates(z: torch.Tensor, c: torch.Tensor, forget_bias: float):
    i, g, f, o = torch.chunk(z, 4, dim=-1)
    new_c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_c, new_h


def lstm_cell(params: Params, x: torch.Tensor,
              state: Tuple[torch.Tensor, torch.Tensor],
              forget_bias: float = 1.0):
    """One [x, h] -> (i, g, f, o) LSTM step; the forget bias is added at
    run time. Returns (h, (c, h))."""
    c, h = state
    z = torch.cat([x, h], dim=-1) @ params["kernel"] + params["bias"]
    new_c, new_h = _lstm_gates(z, c, forget_bias)
    return new_h, (new_c, new_h)


def reverse_sequence(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Reverse the first ``lengths[i]`` steps of each row of [N, T, ...]."""
    T = x.shape[1]
    if lengths is None:
        return torch.flip(x, dims=[1])
    t = torch.arange(T, device=x.device)[None, :]
    lengths = lengths.to(x.device)[:, None]
    idx = torch.where(t < lengths, lengths - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def bilstm_rnn(params_fw: Params, params_bw: Params, x: torch.Tensor,
               lengths: Optional[torch.Tensor], units: int,
               forget_bias: float = 1.0) -> torch.Tensor:
    """Bidirectional LSTM over [N, T, C] -> [N, T, 2*units].

    Both directions step together (the reversed copy is stacked on the
    batch axis) and the input projection of every step is one matmul
    outside the loop. Past each row's length, outputs are zero and the
    state is held."""
    N, T, C = x.shape
    x2 = torch.cat([x, reverse_sequence(x, lengths)], dim=0)      # [2N, T, C]
    wx = torch.stack([params_fw["kernel"][:C], params_bw["kernel"][:C]])
    wh = torch.stack([params_fw["kernel"][C:], params_bw["kernel"][C:]])
    b = torch.stack([params_fw["bias"], params_bw["bias"]])        # [2, 4H]
    xz = (torch.einsum("gntc,gcz->gntz", x2.reshape(2, N, T, C), wx)
          + b[:, None, None]).reshape(2 * N, T, 4 * units)
    mask = None
    if lengths is not None:
        m = torch.arange(T, device=x.device)[None, :] < lengths.to(x.device)[:, None]
        mask = torch.cat([m, m], dim=0)[:, :, None]                 # [2N, T, 1]
    c = x.new_zeros(2 * N, units)
    h = x.new_zeros(2 * N, units)
    outs = []
    for t in range(T):
        hz = torch.bmm(h.reshape(2, N, units), wh).reshape(2 * N, 4 * units)
        new_c, new_h = _lstm_gates(xz[:, t] + hz, c, forget_bias)
        out = new_h
        if mask is not None:
            mt = mask[:, t]
            new_c = torch.where(mt, new_c, c)
            new_h = torch.where(mt, new_h, h)
            out = torch.where(mt, out, torch.zeros_like(out))
        c, h = new_c, new_h
        outs.append(out)
    ys = torch.stack(outs, dim=1)                                   # [2N, T, H]
    return torch.cat([ys[:N], reverse_sequence(ys[N:], lengths)], dim=-1)
