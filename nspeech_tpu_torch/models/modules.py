"""Composite blocks: the CBHG (Tacotron-1), conv + BiLSTM (Tacotron-2's
encoder and expand network) and the postnet. Port of
``nspeech_tpu/models/modules.py``. At inference (the default) batch norm
uses the running statistics and each block returns its output; with
``is_training=True`` it uses the batch's moments and each block returns
``(output, new_bn_state)``, as the JAX package's do.

The CBHG keeps the reference's quirks, which define trained behaviour:
the max-pool output is dropped (projections read the conv bank), every
projection but the last reads the bank, the residual joins before the
128-wide bottleneck dense, and with a speaker each highway layer doubles
the width."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from nspeech_tpu_torch.ops import layers as L

HIGHWAY_DIM = 128


def init_cbhg(rng, in_dim: int, K: int, proj_sizes: Sequence[int],
              gru_units: int = 128, num_highways: int = 4,
              bank_channels: int = 128, speaker_dim: Optional[int] = None):
    """(params, bn_state, meta) of a CBHG: a bank of K conv+BN layers of
    widths 1..K, width-3 projections, highways, a bidirectional GRU."""
    bank_p, bank_s = [], []
    for k in range(1, K + 1):
        p, s = L.init_conv_bn(rng, k, in_dim, bank_channels)
        bank_p.append(p)
        bank_s.append(s)
    n_proj = len(proj_sizes)
    proj_p, proj_s = [], []
    for i, size in enumerate(proj_sizes):
        in_ch = (bank_channels * K if i < n_proj - 1 or n_proj == 1
                 else proj_sizes[n_proj - 2])
        p, s = L.init_conv_bn(rng, 3, in_ch, size)
        proj_p.append(p)
        proj_s.append(s)
    params = {"bank": bank_p, "proj": proj_p}
    if in_dim != HIGHWAY_DIM:
        params["bottleneck"] = L.init_dense(rng, in_dim, HIGHWAY_DIM)
    highways = []
    dim = HIGHWAY_DIM
    for _ in range(num_highways):
        layer = {}
        if speaker_dim is not None:
            layer["spk"] = L.init_dense(rng, speaker_dim, dim)
            dim *= 2
        layer["hw"] = L.init_highway(rng, dim)
        highways.append(layer)
    params["highways"] = highways
    params["gru_fw"] = L.init_gru(rng, dim, gru_units)
    params["gru_bw"] = L.init_gru(rng, dim, gru_units)
    if speaker_dim is not None:
        params["spk_gru"] = L.init_dense(rng, speaker_dim, gru_units)
    return (params, {"bank": bank_s, "proj": proj_s},
            {"K": K, "gru_units": gru_units, "in_dim": in_dim})


def with_state(result, state, is_training: bool):
    """A block's ``(output, new BN state)`` in either mode: at inference
    the block returns the output alone and its state does not change."""
    return result if is_training else (result, state)


def _conv_bn_stack(is_training: bool):
    """``(conv_bn, new_states)``: a conv_bn that, in training, appends
    each layer's new BN state to ``new_states[key]`` (a dict of lists)."""
    new_states = {}

    def run(key, p, s, x, activation):
        if not is_training:
            return L.conv_bn(p, s, x, activation)
        y, ns = L.conv_bn(p, s, x, activation, True)
        new_states.setdefault(key, []).append(ns)
        return y

    return run, new_states


def cbhg(params, state, meta, x: torch.Tensor, lengths,
         speaker_embd: Optional[torch.Tensor], is_training: bool = False):
    """[N, T, in_dim] -> [N, T, 2 * gru_units]."""
    conv_bn, new_state = _conv_bn_stack(is_training)
    conv_bank = torch.cat([conv_bn("bank", p, s, x, torch.relu)
                           for p, s in zip(params["bank"], state["bank"])],
                          dim=-1)
    n_proj = len(params["proj"])
    conv_proj = conv_bank
    for i, (p, s) in enumerate(zip(params["proj"], state["proj"])):
        src = conv_bank if (i < n_proj - 1 or n_proj == 1) else conv_proj
        conv_proj = conv_bn("proj", p, s, src,
                            torch.relu if i < n_proj - 1 else None)
    h = conv_proj + x
    if "bottleneck" in params:
        h = L.dense(params["bottleneck"], h)
    for layer in params["highways"]:
        if speaker_embd is not None and "spk" in layer:
            s = L.dense(layer["spk"], speaker_embd, L.softsign)
            h = torch.cat([h, s[:, None, :].expand(h.shape[0], h.shape[1], -1)],
                          dim=-1)
        h = L.highway(layer["hw"], h)
    h0 = None
    if speaker_embd is not None and "spk_gru" in params:
        h0 = L.dense(params["spk_gru"], speaker_embd, L.softsign)
    out = L.bigru_rnn(params["gru_fw"], params["gru_bw"], h, h0, lengths,
                      meta["gru_units"])
    return (out, new_state) if is_training else out


def init_conv_and_lstm(rng, in_dim: int, conv_layers: int, conv_width: int,
                       conv_channels: int, lstm_units: int):
    conv_p, conv_s = [], []
    ch = in_dim
    for _ in range(conv_layers):
        p, s = L.init_conv_bn(rng, conv_width, ch, conv_channels)
        conv_p.append(p)
        conv_s.append(s)
        ch = conv_channels
    params = {"convs": conv_p,
              "lstm_fw": L.init_lstm(rng, ch, lstm_units),
              "lstm_bw": L.init_lstm(rng, ch, lstm_units)}
    return params, {"convs": conv_s}, {"lstm_units": lstm_units}


def conv_and_lstm(params, state, meta, x: torch.Tensor, lengths,
                  is_training: bool = False, taps=None, name: str = ""):
    """Conv+BN stack (ReLU on all but the last conv) then a BiLSTM, whose
    recurrent kernels' gradients are deferred when ``taps`` holds
    ``name`` (``layers.bilstm_rnn``)."""
    conv_bn, new_state = _conv_bn_stack(is_training)
    n = len(params["convs"])
    for i, (p, s) in enumerate(zip(params["convs"], state["convs"])):
        x = conv_bn("convs", p, s, x, torch.relu if i < n - 1 else None)
    if taps is not None and name not in taps:
        taps = None
    out = L.bilstm_rnn(params["lstm_fw"], params["lstm_bw"], x, lengths,
                       meta["lstm_units"], taps=taps, name=name)
    return (out, new_state) if is_training else out


def init_postnet(rng, in_dim: int, conv_layers: int, conv_width: int,
                 channels: int):
    conv_p, conv_s = [], []
    ch = in_dim
    for _ in range(conv_layers):
        p, s = L.init_conv_bn(rng, conv_width, ch, channels)
        conv_p.append(p)
        conv_s.append(s)
        ch = channels
    return ({"convs": conv_p, "out": L.init_dense(rng, ch, in_dim)},
            {"convs": conv_s})


def postnet(params, state, x: torch.Tensor, is_training: bool = False):
    """Conv+BN stack (tanh on all but the last conv) then a dense back to
    the mel width: the residual added to the decoder frames."""
    conv_bn, new_state = _conv_bn_stack(is_training)
    n = len(params["convs"])
    y = x
    for i, (p, s) in enumerate(zip(params["convs"], state["convs"])):
        y = conv_bn("convs", p, s, y, torch.tanh if i < n - 1 else None)
    out = L.dense(params["out"], y)
    return (out, new_state) if is_training else out
