"""Plain Tacotron-2 (Shen et al. 2018, arXiv:1712.05884) at the layout of
the reference recipe (MLCogUP/nspeech ``hparams/taco2.yaml``).

Encoder: embedding, convolutions with batch norm (ReLU on all but the
last), a BiLSTM over each row's length. Decoder step: prenet (256, 128;
dropout only in training) over [previous frame, previous context], the
attention LSTM, location-sensitive attention (a bias-free 7-tap
convolution of the previous alignment to 20 filters, projected to the
attention width; energy v . tanh(keys + query + location)), two LSTMs
over [attention h, context] and then the first's output, a projection
to r frames. Postnet: convolutions with batch norm (tanh on all but the
last) and a dense back to the mel width, added to the decoder frames.
Expand network (training only here): convolutions, a BiLSTM and a
projection to the linear spectrogram.

Departures from the paper that the recipe makes, kept here: no stop
token (a frame whose every value is exactly 0 ends a row; random weights
never produce one, so a decode runs its whole budget), the expand
network in place of a vocoder input, the conv -> activation -> batch
norm order, and the decoder's first LSTM reading the attention LSTM."""

from __future__ import annotations

import torch

from benchmark.reference import mm, nn
from benchmark.reference.text import VOCAB

PRENET = (256, 128)


def param_shapes(cfg):
    """(params, bn state) shape trees of the recipe at ``cfg``'s widths."""
    M, r = cfg["num_mels"], cfg["outputs_per_step"]
    A, D = cfg["attention_dim"], cfg["decoder_lstm_units"]
    He, Hx = cfg["encoder_lstm_units"], cfg["expand_lstm_units"]
    Dm = 2 * He
    enc_p, enc_s = nn.conv_stack_shape(cfg["embedding_dim"],
                                       cfg["encoder_conv_layers"],
                                       cfg["encoder_conv_width"],
                                       cfg["encoder_conv_channels"])
    post_p, post_s = nn.conv_stack_shape(M, cfg["postnet_conv_layers"],
                                         cfg["postnet_conv_width"],
                                         cfg["postnet_conv_channels"])
    exp_p, exp_s = nn.conv_stack_shape(M, cfg["expand_conv_layers"],
                                       cfg["expand_conv_width"],
                                       cfg["expand_conv_channels"])
    Ce, Cx = cfg["encoder_conv_channels"], cfg["expand_conv_channels"]
    params = {
        "embedding": {"table": ((VOCAB, cfg["embedding_dim"]), ("embed",))},
        "encoder": {"convs": enc_p, "lstm_fw": nn.lstm_shape(Ce, He),
                    "lstm_bw": nn.lstm_shape(Ce, He)},
        "attention": {
            "memory_layer": nn.dense_shape(Dm, A, bias=False),
            "query_layer": nn.dense_shape(A, A, bias=False),
            "v": ((A,), ("glorot", A, 1)),
            "location_conv": nn.conv_shape(7, 1, 20, bias=False),
            "location_layer": nn.dense_shape(20, A, bias=False)},
        "decoder_prenet": {"layers": [nn.dense_shape(M + Dm, PRENET[0]),
                                      nn.dense_shape(PRENET[0], PRENET[1])]},
        "attn_lstm": nn.lstm_shape(PRENET[1], A),
        "lstm1": nn.lstm_shape(A + Dm, D),
        "lstm2": nn.lstm_shape(D, D),
        "frame_proj": nn.dense_shape(D, M * r),
        "postnet": {"convs": post_p,
                    "out": nn.dense_shape(cfg["postnet_conv_channels"], M)},
        "expand": {"convs": exp_p, "lstm_fw": nn.lstm_shape(Cx, Hx),
                   "lstm_bw": nn.lstm_shape(Cx, Hx)},
        "linear_proj": nn.dense_shape(2 * Hx, cfg["num_freq"],
                                      bias_init="spectrogram_bias"),
    }
    state = {"encoder": {"convs": enc_s}, "postnet": {"convs": post_s},
             "expand": {"convs": exp_s}}
    return params, state


def _conv_stack(ps, ss, x, act, training):
    n = len(ps)
    for i, (p, s) in enumerate(zip(ps, ss)):
        x = nn.conv_bn(p, s, x, act if i < n - 1 else None, training)
    return x


def encode(cfg, params, state, ids, lengths, training=False):
    """(attention keys, memory, mask) of ids [N, T_in] padded with 0."""
    x = params["embedding"]["table"][ids]
    x = _conv_stack(params["encoder"]["convs"], state["encoder"]["convs"], x,
                    torch.relu, training)
    memory = nn.birnn(params["encoder"]["lstm_fw"], params["encoder"]["lstm_bw"],
                      x, lengths, cfg["encoder_lstm_units"], lstm=True)
    keys = mm(memory, params["attention"]["memory_layer"]["kernel"])
    mask = (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < torch.clamp(lengths, min=1)[:, None])
    return keys, memory, mask


def _prenet(layers, x, masks=None, keep=1.0):
    """Dense + ReLU layers; with ``masks``, inverted dropout that keeps
    with probability ``keep``."""
    for i, p in enumerate(layers):
        x = nn.dense(p, x, torch.relu)
        if masks is not None:
            x = torch.where(masks[i], x / keep, torch.zeros_like(x))
    return x


def _attend(p, query, prev_align, keys, memory, mask):
    q = mm(query, p["query_layer"]["kernel"])
    f = nn.conv1d(p["location_conv"], prev_align[:, :, None])
    energy = torch.tanh(keys + q[:, None, :]
                        + mm(f, p["location_layer"]["kernel"]))
    score = mm(energy, p["v"]).masked_fill(~mask, float("-inf"))
    align = torch.softmax(score, dim=-1)
    return mm(align[:, None, :], memory)[:, 0], align


def decoder_step(params, carry, x, keys, memory, mask, masks=None, keep=1.0):
    """One step: carry (c1, h1, context, align, c2, h2, c3, h3) and the
    input frame x [N, M] -> (carry, r frames [N, r * M])."""
    c1, h1, ctx, align, c2, h2, c3, h3 = carry
    pre = _prenet(params["decoder_prenet"]["layers"],
                  torch.cat([x, ctx], dim=-1), masks, keep)
    c1, h1 = nn.lstm_cell(params["attn_lstm"], pre, c1, h1)
    ctx, align = _attend(params["attention"], h1, align, keys, memory, mask)
    c2, h2 = nn.lstm_cell(params["lstm1"], torch.cat([h1, ctx], dim=-1), c2, h2)
    c3, h3 = nn.lstm_cell(params["lstm2"], h2, c3, h3)
    out = nn.dense(params["frame_proj"], h3)
    return (c1, h1, ctx, align, c2, h2, c3, h3), out


def carry0(cfg, n, t_in, device):
    z = lambda d: torch.zeros(n, d, device=device)     # noqa: E731
    A, D, Dm = (cfg["attention_dim"], cfg["decoder_lstm_units"],
                2 * cfg["encoder_lstm_units"])
    return (z(A), z(A), z(Dm), z(t_in), z(D), z(D), z(D), z(D))


def postnet(cfg, params, state, frames, training=False):
    y = _conv_stack(params["postnet"]["convs"], state["postnet"]["convs"],
                    frames, torch.tanh, training)
    return frames + nn.dense(params["postnet"]["out"], y)


@torch.no_grad()
def infer_mel(cfg, params, state, ids, lengths, steps: int):
    """The autoregressive decode of ``steps`` steps from a zero GO frame
    and the postnet: mel [N, steps * r, M]."""
    M, r = cfg["num_mels"], cfg["outputs_per_step"]
    n = ids.shape[0]
    keys, memory, mask = encode(cfg, params, state, ids, lengths)
    carry = carry0(cfg, n, ids.shape[1], ids.device)
    x = torch.zeros(n, M, device=ids.device)
    outs = []
    for _ in range(steps):
        carry, out = decoder_step(params, carry, x, keys, memory, mask)
        outs.append(out)
        x = out[:, -M:]
    frames = torch.stack(outs, dim=1).reshape(n, steps * r, M)
    return postnet(cfg, params, state, frames)


def forward_train(cfg, params, state, ids, lengths, mel_targets, masks):
    """Teacher-forced forward in training mode: (mel, linear). ``masks``
    holds each decoder step's two prenet keep-masks."""
    M, r = cfg["num_mels"], cfg["outputs_per_step"]
    n, t_out = mel_targets.shape[:2]
    keys, memory, mask = encode(cfg, params, state, ids, lengths, True)
    teacher = mel_targets[:, r - 1::r]
    inputs = torch.cat([torch.zeros_like(teacher[:, :1]), teacher[:, :-1]], dim=1)
    carry = carry0(cfg, n, ids.shape[1], ids.device)
    outs = []
    for s in range(t_out // r):
        carry, out = decoder_step(params, carry, inputs[:, s], keys, memory,
                                  mask, masks[s], 1.0 - cfg["drop_rate"])
        outs.append(out)
    frames = torch.stack(outs, dim=1).reshape(n, t_out, M)
    mel = postnet(cfg, params, state, frames, True)
    x = _conv_stack(params["expand"]["convs"], state["expand"]["convs"], mel,
                    torch.relu, True)
    x = nn.birnn(params["expand"]["lstm_fw"], params["expand"]["lstm_bw"], x,
                 None, cfg["expand_lstm_units"], lstm=True)
    return mel, nn.dense(params["linear_proj"], x)


def loss(cfg, mel, linear, mel_targets, linear_targets, priority_hz=2000.0):
    """Mean L1 of the mel, plus half the linear L1 and half of it below
    ``priority_hz`` (means over the padded frames too)."""
    n_priority = int(priority_hz / (cfg["sample_rate"] * 0.5) * cfg["num_freq"])
    l1 = torch.abs(linear_targets - linear)
    return (torch.mean(torch.abs(mel_targets - mel))
            + 0.5 * torch.mean(l1) + 0.5 * torch.mean(l1[:, :, :n_priority]))
