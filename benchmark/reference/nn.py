"""Layers of the plain references, over parameter dicts.

Layouts: a dense kernel is [in, out]; a convolution kernel [width, in,
out] ('SAME' padding, computed here as one product over the unfolded
windows, not through cuDNN); an LSTM kernel maps [x, h] to the gates in
(i, g, f, o) order with a forget bias of 1 added at run time; a GRU has
TensorFlow's gate kernel over [x, h] (reset, update) and candidate kernel
over [x, r * h]. Batch norm follows the activation (conv -> activation ->
batch norm), with epsilon 1e-3.

Shape trees (``*_shapes`` in the model files) give each leaf as
``(shape, init)``; :func:`leaf_inits` names the initialisations the
benchmark's weight maker understands."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from benchmark.reference import mm

BN_EPS = 1e-3


def dense(p, x, act=None):
    y = mm(x, p["kernel"])
    if "bias" in p:
        y = y + p["bias"]
    return act(y) if act is not None else y


def conv1d(p, x):
    """'SAME' convolution of x [N, T, C] -> [N, T, C_out]."""
    w = p["kernel"]
    width, c_in, c_out = w.shape
    left = (width - 1) // 2
    xp = F.pad(x, (0, 0, left, width - 1 - left))
    cols = xp.unfold(1, width, 1)                      # [N, T, C, W]
    n, t = cols.shape[:2]
    y = mm(cols.transpose(2, 3).reshape(n, t, width * c_in), w.reshape(width * c_in, c_out))
    return y + p["bias"] if "bias" in p else y


def batch_norm(p, s, x, training: bool = False):
    """Inference: the running statistics ``s``. Training: the batch's
    moments over every axis but the last (biased variance)."""
    if training:
        axes = tuple(range(x.ndim - 1))
        mean, var = x.mean(dim=axes), x.var(dim=axes, correction=0)
    else:
        mean, var = s["mean"], s["var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * p["scale"] + p["offset"]


def conv_bn(p, s, x, act, training: bool = False):
    y = conv1d(p["conv"], x)
    if act is not None:
        y = act(y)
    return batch_norm(p["bn"], s["bn"], y, training)


def lstm_cell(p, x, c, h):
    z = mm(torch.cat([x, h], dim=-1), p["kernel"]) + p["bias"]
    i, g, f, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def gru_cell(p, x, h):
    gates = torch.sigmoid(mm(torch.cat([x, h], dim=-1), p["gate_kernel"]) + p["gate_bias"])
    r, u = torch.chunk(gates, 2, dim=-1)
    cand = torch.tanh(mm(torch.cat([x, r * h], dim=-1), p["cand_kernel"]) + p["cand_bias"])
    return u * h + (1.0 - u) * cand


def reverse_within(x, lengths: Optional[torch.Tensor]):
    """Reverse the first ``lengths[i]`` steps of each row of [N, T, ...]."""
    if lengths is None:
        return torch.flip(x, dims=[1])
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    ln = lengths[:, None]
    idx = torch.where(t < ln, ln - 1 - t, t)
    return torch.stack([x[i, idx[i]] for i in range(x.shape[0])])


def _run(cell, x, lengths, units, lstm: bool):
    """One direction over [N, T, C]: past a row's length the output is
    zero and the state held."""
    n, t_len, _ = x.shape
    h = x.new_zeros(n, units)
    c = x.new_zeros(n, units)
    outs = []
    for t in range(t_len):
        if lstm:
            c2, h2 = cell(x[:, t], c, h)
        else:
            h2 = cell(x[:, t], h)
            c2 = c
        if lengths is not None:
            live = (t < lengths)[:, None]
            h2 = torch.where(live, h2, h)
            c2 = torch.where(live, c2, c)
            out = torch.where(live, h2, torch.zeros_like(h2))
        else:
            out = h2
        h, c = h2, c2
        outs.append(out)
    return torch.stack(outs, dim=1)


def birnn(p_fw, p_bw, x, lengths, units: int, lstm: bool):
    """Bidirectional LSTM (``lstm``) or GRU: [N, T, C] -> [N, T, 2 units];
    the backward direction reads each row's valid steps reversed."""
    if lstm:
        fw_cell = lambda x_, c_, h_: lstm_cell(p_fw, x_, c_, h_)   # noqa: E731
        bw_cell = lambda x_, c_, h_: lstm_cell(p_bw, x_, c_, h_)   # noqa: E731
    else:
        fw_cell = lambda x_, h_: gru_cell(p_fw, x_, h_)            # noqa: E731
        bw_cell = lambda x_, h_: gru_cell(p_bw, x_, h_)            # noqa: E731
    fw = _run(fw_cell, x, lengths, units, lstm)
    bw = _run(bw_cell, reverse_within(x, lengths), lengths, units, lstm)
    return torch.cat([fw, reverse_within(bw, lengths)], dim=-1)


# -- shape trees -------------------------------------------------------------

def dense_shape(i, o, bias=True, bias_init="bias"):
    d = {"kernel": ((i, o), ("glorot", i, o))}
    if bias:
        d["bias"] = ((o,), (bias_init,))
    return d


def conv_shape(w, i, o, bias=True):
    d = {"kernel": ((w, i, o), ("glorot", w * i, w * o))}
    if bias:
        d["bias"] = ((o,), ("bias",))
    return d


def conv_bn_shape(w, i, o):
    """(params, bn state) of a conv + batch norm."""
    return ({"conv": conv_shape(w, i, o),
             "bn": {"scale": ((o,), ("bn_scale",)),
                    "offset": ((o,), ("bn_offset",))}},
            {"bn": {"mean": ((o,), ("bn_mean",)), "var": ((o,), ("bn_var",))}})


def lstm_shape(i, units):
    return {"kernel": ((i + units, 4 * units), ("glorot", i + units, 4 * units)),
            "bias": ((4 * units,), ("bias",))}


def gru_shape(i, units):
    return {"gate_kernel": ((i + units, 2 * units),
                            ("glorot", i + units, 2 * units)),
            "gate_bias": ((2 * units,), ("gru_gate_bias",)),
            "cand_kernel": ((i + units, units), ("glorot", i + units, units)),
            "cand_bias": ((units,), ("bias",))}


def conv_stack_shape(i, layers, w, ch):
    ps, ss = [], []
    for _ in range(layers):
        p, s = conv_bn_shape(w, i, ch)
        ps.append(p)
        ss.append(s)
        i = ch
    return ps, ss


def leaf_inits():
    """Each init name -> (centre, half-width) of its uniform draw; a
    glorot kernel's half-width is sqrt(6 / (fan_in + fan_out)). The
    linear projection's bias puts a random model's spectrogram near the
    middle of its normalised [0, 1] range, as a trained model's is, so
    that Griffin-Lim's waveform is audible and not trimmed to its first
    windows."""
    return {"bias": (0.0, 0.1), "gru_gate_bias": (1.0, 0.1),
            "hw_gate_bias": (-1.0, 0.1), "bn_scale": (1.0, 0.1),
            "bn_offset": (0.0, 0.1), "bn_mean": (0.0, 0.1),
            "bn_var": (1.0, 0.2), "embed": (0.0, 3.0 ** 0.5),
            "spectrogram_bias": (0.55, 0.1)}
