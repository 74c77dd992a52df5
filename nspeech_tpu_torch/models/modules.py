"""Tacotron-2 composite blocks: conv + BiLSTM (encoder / expand network)
and the postnet. Port of the inference side of
``nspeech_tpu/models/modules.py``; batch norm uses running statistics."""

from __future__ import annotations

import torch

from nspeech_tpu_torch.ops import layers as L


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


def conv_and_lstm(params, state, meta, x: torch.Tensor, lengths) -> torch.Tensor:
    """Conv+BN stack (ReLU on all but the last conv) then a BiLSTM."""
    n = len(params["convs"])
    for i, (p, s) in enumerate(zip(params["convs"], state["convs"])):
        x = L.conv_bn(p, s, x, torch.relu if i < n - 1 else None)
    return L.bilstm_rnn(params["lstm_fw"], params["lstm_bw"], x, lengths,
                        meta["lstm_units"])


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


def postnet(params, state, x: torch.Tensor) -> torch.Tensor:
    """Conv+BN stack (tanh on all but the last conv) then a dense back to
    the mel width: the residual added to the decoder frames."""
    n = len(params["convs"])
    y = x
    for i, (p, s) in enumerate(zip(params["convs"], state["convs"])):
        y = L.conv_bn(p, s, y, torch.tanh if i < n - 1 else None)
    return L.dense(params["out"], y)
