"""Neural-net building blocks as functions over parameter dicts.

Port of ``nspeech_tpu/ops/layers.py``. Parameters keep the JAX package's
names, shapes and layouts (a dense kernel is [in, out], a conv kernel
[width, in, out], an LSTM kernel one [x, h] -> 4*units matrix with gates
in (i, g, f, o) order, a GRU TF's gate and candidate kernels), so bridged
weights are used as they are. Initializers draw from a
``numpy.random.Generator`` with the same distributions as the JAX package
(glorot-uniform kernels, truncated-normal embeddings). Batch norm and the
prenet have a training mode (batch moments and their running update;
inverted dropout from a ``torch.Generator``); without it they are the
inference functions.

Under the bf16 compute policy (``ops/policy.py``) every layer keeps the
dtype it is given: products go through :func:`acc_dot` and
:func:`acc_einsum` (float32 accumulation, one rounding), batch norm
computes in float32 and returns the input dtype, and the recurrent zero
states take the input's dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nspeech_tpu_torch.ops.policy import upcast

Params = Dict[str, object]

BN_MOMENTUM = 0.99
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


def init_highway(rng, dim: int) -> Params:
    """Highway layer: transform ``H`` and gate ``T`` (gate bias -1)."""
    h = init_dense(rng, dim, dim)
    t = init_dense(rng, dim, dim)
    t["bias"] = torch.full((dim,), -1.0)
    return {"H": h, "T": t}


def init_gru(rng, in_dim: int, units: int) -> Params:
    """TF GRUCell layout: a gate kernel over [x, h] -> 2*units (reset,
    update) with bias 1, a candidate kernel over [x, r*h] -> units with
    bias 0."""
    return {"gate_kernel": glorot_uniform(rng, (in_dim + units, 2 * units),
                                          in_dim + units, 2 * units),
            "gate_bias": torch.ones(2 * units),
            "cand_kernel": glorot_uniform(rng, (in_dim + units, units),
                                          in_dim + units, units),
            "cand_bias": torch.zeros(units)}


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


def acc_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for operands of one dtype, the product the policy's
    float32 accumulation is promised for (JAX's
    ``preferred_element_type=float32`` followed by the cast). The
    accumulation itself is the backend's: the CPU's bf16 kernels
    accumulate in float32 and round once, and cuBLAS's bf16 GEMMs do so
    only with reduced-precision reductions off, a global flag that
    ``policy.set_matmul_precision`` sets in every entry point. In float32
    it is the plain product."""
    return x @ w


def acc_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The einsum twin of :func:`acc_dot` (same dtype in, the same
    accumulation, under the same global flag)."""
    return torch.einsum(spec, a, b)


def dense(params: Params, x: torch.Tensor, activation=None) -> torch.Tensor:
    y = acc_dot(x, params["kernel"])
    if "bias" in params:
        y = y + params["bias"]
    return activation(y) if activation is not None else y


def embedding(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def conv1d(params: Params, x: torch.Tensor) -> torch.Tensor:
    """'SAME' 1-D convolution: x [N, T, C] -> [N, T, C_out], in ``x``'s
    dtype (a bf16 convolution accumulates in float32 in cuDNN and on the
    CPU)."""
    w = params["kernel"]                       # [W, Cin, Cout]
    width = w.shape[0]
    left = (width - 1) // 2
    xt = F.pad(x.transpose(1, 2), (left, width - 1 - left))
    y = F.conv1d(xt, w.permute(2, 1, 0), params.get("bias"))
    return y.transpose(1, 2)


def batch_norm(params: Params, state: Params, x: torch.Tensor,
               is_training: bool = False):
    """Batch norm over the last axis. At inference: the running
    statistics, returns y. In training (``is_training=True``): the moments
    of ``x`` over all leading axes (padded frames included, the variance
    the biased one, as ``jnp.var``), returns ``(y, new_state)`` with the
    running statistics moved by momentum ``BN_MOMENTUM``. A bf16 ``x`` is
    normalized in float32 (moments and running statistics included) and
    the result returned in bf16."""
    xf = upcast(x)
    scale, offset = upcast(params["scale"]), upcast(params["offset"])
    if not is_training:
        inv = torch.rsqrt(state["var"] + BN_EPS) * scale
        return ((xf - state["mean"]) * inv + offset).to(x.dtype)
    axes = tuple(range(x.ndim - 1))
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, correction=0)
    new_state = {
        "mean": BN_MOMENTUM * state["mean"] + (1 - BN_MOMENTUM) * mean.detach(),
        "var": BN_MOMENTUM * state["var"] + (1 - BN_MOMENTUM) * var.detach(),
    }
    inv = torch.rsqrt(var + BN_EPS) * scale
    return ((xf - mean) * inv + offset).to(x.dtype), new_state


def conv_bn(params: Params, state: Params, x: torch.Tensor, activation,
            is_training: bool = False):
    """conv -> activation -> batch norm (the reference's order). Returns y
    at inference, ``(y, {"bn": new_state})`` in training."""
    y = conv1d(params["conv"], x)
    if activation is not None:
        y = activation(y)
    if not is_training:
        return batch_norm(params["bn"], state["bn"], y)
    y, bn = batch_norm(params["bn"], state["bn"], y, True)
    return y, {"bn": bn}


def prenet(params: Params, x: torch.Tensor, drop_rate: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stacked dense+relu; with ``drop_rate`` > 0 and a ``generator``,
    inverted dropout after each layer (keep with probability
    ``1 - drop_rate``, scale kept values by ``1 / (1 - drop_rate)``)."""
    for layer in params["layers"]:
        x = dense(layer, x, torch.relu)
        if drop_rate > 0.0 and generator is not None:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) < 1.0 - drop_rate
            x = torch.where(keep, x / (1.0 - drop_rate), torch.zeros_like(x))
    return x


def highway(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = dense(params["H"], x, torch.relu)
    t = dense(params["T"], x, torch.sigmoid)
    return h * t + x * (1.0 - t)


def gru_cell(params: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One TF GRU step; returns the new state. The candidate reads [x, r*h]
    through one kernel (``torch.nn.GRUCell`` computes r * (W_hn h + b_hn)
    instead, a different function)."""
    gates = torch.sigmoid(acc_dot(torch.cat([x, h], dim=-1),
                                  params["gate_kernel"]) + params["gate_bias"])
    r, u = torch.chunk(gates, 2, dim=-1)
    c = torch.tanh(acc_dot(torch.cat([x, r * h], dim=-1), params["cand_kernel"])
                   + params["cand_bias"])
    return u * h + (1.0 - u) * c


def _length_mask(lengths: Optional[torch.Tensor], T: int, device):
    """[N, T, 1] bool validity mask, or None without lengths."""
    if lengths is None:
        return None
    return (torch.arange(T, device=device)[None, :]
            < lengths.to(device)[:, None])[:, :, None]


def gru_rnn(params: Params, x: torch.Tensor, h0: Optional[torch.Tensor],
            lengths: Optional[torch.Tensor], units: int) -> torch.Tensor:
    """Unidirectional GRU over [N, T, C] -> [N, T, units]. Past each row's
    length, outputs are zero and the state is held."""
    N, T, _ = x.shape
    h = x.new_zeros(N, units) if h0 is None else h0
    mask = _length_mask(lengths, T, x.device)
    outs = []
    for t in range(T):
        new_h = gru_cell(params, x[:, t], h)
        out = new_h
        if mask is not None:
            new_h = torch.where(mask[:, t], new_h, h)
            out = torch.where(mask[:, t], out, torch.zeros_like(out))
        h = new_h
        outs.append(out)
    return torch.stack(outs, dim=1)


def bigru_rnn(params_fw: Params, params_bw: Params, x: torch.Tensor,
              h0: Optional[torch.Tensor], lengths: Optional[torch.Tensor],
              units: int) -> torch.Tensor:
    """Bidirectional GRU over [N, T, C] -> [N, T, 2*units], both directions
    in one loop (as :func:`bilstm_rnn`). ``h0`` [N, units] (a speaker's
    initial state) seeds both directions."""
    N, T, C = x.shape
    x4 = torch.cat([x, reverse_sequence(x, lengths)], dim=0).reshape(2, N, T, C)

    def split(name):
        return (torch.stack([params_fw[name][:C], params_bw[name][:C]]),
                torch.stack([params_fw[name][C:], params_bw[name][C:]]))

    gx, gh = split("gate_kernel")
    cx, ch = split("cand_kernel")
    gb = torch.stack([params_fw["gate_bias"], params_bw["gate_bias"]])
    cb = torch.stack([params_fw["cand_bias"], params_bw["cand_bias"]])
    xg = (acc_einsum("gntc,gcz->gntz", x4, gx)
          + gb[:, None, None]).reshape(2 * N, T, 2 * units)
    xc = (acc_einsum("gntc,gcz->gntz", x4, cx)
          + cb[:, None, None]).reshape(2 * N, T, units)
    mask = _length_mask(lengths, T, x.device)
    if mask is not None:
        mask = torch.cat([mask, mask], dim=0)                       # [2N, T, 1]
    h = (x.new_zeros(2 * N, units) if h0 is None
         else torch.cat([h0, h0], dim=0))
    outs = []
    for t in range(T):
        hg = torch.bmm(h.reshape(2, N, units), gh).reshape(2 * N, 2 * units)
        r, u = torch.chunk(torch.sigmoid(xg[:, t] + hg), 2, dim=-1)
        hc = torch.bmm((r * h).reshape(2, N, units), ch).reshape(2 * N, units)
        new_h = u * h + (1.0 - u) * torch.tanh(xc[:, t] + hc)
        out = new_h
        if mask is not None:
            new_h = torch.where(mask[:, t], new_h, h)
            out = torch.where(mask[:, t], out, torch.zeros_like(out))
        h = new_h
        outs.append(out)
    ys = torch.stack(outs, dim=1)                                   # [2N, T, H]
    return torch.cat([ys[:N], reverse_sequence(ys[N:], lengths)], dim=-1)


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
    z = acc_dot(torch.cat([x, h], dim=-1), params["kernel"]) + params["bias"]
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
               forget_bias: float = 1.0, taps=None,
               name: str = "") -> torch.Tensor:
    """Bidirectional LSTM over [N, T, C] -> [N, T, 2*units].

    Both directions step together (the reversed copy is stacked on the
    batch axis) and the input projection of every step is one matmul
    outside the loop. Past each row's length, outputs are zero and the
    state is held.

    ``taps`` (an ``ops.deferred.Taps`` holding ``name`` [T, 2N, 4*units])
    defers the recurrent kernels' gradients: the ``h @ wh`` rows enter
    the loop detached, each step's pre-activation is tapped with the
    entry state as its input, and ``deferred.bilstm_wh_grads`` recovers
    them after the backward pass."""
    N, T, C = x.shape
    x2 = torch.cat([x, reverse_sequence(x, lengths)], dim=0)      # [2N, T, C]
    wx = torch.stack([params_fw["kernel"][:C], params_bw["kernel"][:C]])
    wh = torch.stack([params_fw["kernel"][C:], params_bw["kernel"][C:]])
    if taps is not None:
        wh = wh.detach()
    b = torch.stack([params_fw["bias"], params_bw["bias"]])        # [2, 4H]
    xz = (acc_einsum("gntc,gcz->gntz", x2.reshape(2, N, T, C), wx)
          + b[:, None, None]).reshape(2 * N, T, 4 * units)
    mask = _length_mask(lengths, T, x.device)
    if mask is not None:
        mask = torch.cat([mask, mask], dim=0)                       # [2N, T, 1]
    c = x.new_zeros(2 * N, units)
    h = x.new_zeros(2 * N, units)
    outs = []
    for t in range(T):
        hz = torch.bmm(h.reshape(2, N, units), wh).reshape(2 * N, 4 * units)
        pre = xz[:, t] + hz
        if taps is not None:
            pre = taps.tap(name, pre, h)
        new_c, new_h = _lstm_gates(pre, c, forget_bias)
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
