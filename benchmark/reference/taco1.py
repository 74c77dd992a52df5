"""Plain Tacotron-1 (Wang et al. 2017, arXiv:1703.10135) at the layout of
the reference recipe (MLCogUP/nspeech ``hparams/taco1.yaml``), inference.

Encoder: embedding, prenet (256, 128), CBHG (a bank of K convolutions of
widths 1..K with batch norm and ReLU, projections of width 3, four
highway layers, a bidirectional GRU of 128 over each row's length).
Decoder step: prenet (256, 128) over [previous frame, previous context],
the attention GRU, Bahdanau attention (v . tanh(keys + query)), a
projection of [attention h, context] to the decoder width, two residual
GRUs, a projection to r frames. The decoder frames are the mel; the
post-CBHG (K = 8, projections 256 and the mel width) and a projection
give the linear spectrogram.

The recipe's CBHG departs from the paper, and so does this reference:
the max-pool's output is not used (the projections read the conv bank),
every projection but the last reads the bank, the last reads the one
before it, and the residual joins before the 128-wide bottleneck."""

from __future__ import annotations

import torch

from benchmark.reference import mm, nn
from benchmark.reference.text import VOCAB

GRU_UNITS = HIGHWAY = BANK = 128
PRENET = (256, 128)


def _cbhg_shapes(in_dim, K, proj_sizes):
    bank_p, bank_s = [], []
    for k in range(1, K + 1):
        p, s = nn.conv_bn_shape(k, in_dim, BANK)
        bank_p.append(p)
        bank_s.append(s)
    proj_p, proj_s = [], []
    n = len(proj_sizes)
    for i, size in enumerate(proj_sizes):
        c_in = BANK * K if (i < n - 1 or n == 1) else proj_sizes[n - 2]
        p, s = nn.conv_bn_shape(3, c_in, size)
        proj_p.append(p)
        proj_s.append(s)
    params = {"bank": bank_p, "proj": proj_p}
    if in_dim != HIGHWAY:
        params["bottleneck"] = nn.dense_shape(in_dim, HIGHWAY)
    hw = []
    for _ in range(4):
        t = nn.dense_shape(HIGHWAY, HIGHWAY)
        t["bias"] = ((HIGHWAY,), ("hw_gate_bias",))
        hw.append({"hw": {"H": nn.dense_shape(HIGHWAY, HIGHWAY), "T": t}})
    params["highways"] = hw
    params["gru_fw"] = nn.gru_shape(HIGHWAY, GRU_UNITS)
    params["gru_bw"] = nn.gru_shape(HIGHWAY, GRU_UNITS)
    return params, {"bank": bank_s, "proj": proj_s}


def param_shapes(cfg):
    M, r = cfg["num_mels"], cfg["outputs_per_step"]
    A, Dd = cfg["attention_dim"], cfg["decoder_dim"]
    E = cfg["embedding_dim"]
    pre = cfg["encoder_prenet"]
    enc_p, enc_s = _cbhg_shapes(pre[-1], cfg["encoder_cbhg_banks"],
                                list(cfg["encoder_cbhg_bank_sizes"]))
    post_p, post_s = _cbhg_shapes(M, cfg["post_cbhg_banks"],
                                  list(cfg["post_cbhg_bank_sizes"]) + [M])
    Dm = 2 * GRU_UNITS
    params = {
        "embedding": {"table": ((VOCAB, E), ("embed",))},
        "encoder_prenet": {"layers": [nn.dense_shape(E, pre[0]),
                                      nn.dense_shape(pre[0], pre[1])]},
        "encoder_cbhg": enc_p,
        "attention": {"memory_layer": nn.dense_shape(Dm, A, bias=False),
                      "query_layer": nn.dense_shape(A, A, bias=False),
                      "v": ((A,), ("glorot", A, 1))},
        "decoder_prenet": {"layers": [nn.dense_shape(M + Dm, PRENET[0]),
                                      nn.dense_shape(PRENET[0], PRENET[1])]},
        "attn_gru": nn.gru_shape(PRENET[1], A),
        "out_proj": nn.dense_shape(A + Dm, Dd),
        "gru2": nn.gru_shape(Dd, Dd),
        "gru3": nn.gru_shape(Dd, Dd),
        "frame_proj": nn.dense_shape(Dd, M * r),
        "post_cbhg": post_p,
        "linear_proj": nn.dense_shape(2 * GRU_UNITS, cfg["num_freq"],
                                      bias_init="spectrogram_bias"),
    }
    return params, {"encoder_cbhg": enc_s, "post_cbhg": post_s}


def cbhg(p, s, x, lengths):
    bank = torch.cat([nn.conv_bn(bp, bs, x, torch.relu)
                      for bp, bs in zip(p["bank"], s["bank"])], dim=-1)
    n = len(p["proj"])
    proj = bank
    for i, (pp, ps) in enumerate(zip(p["proj"], s["proj"])):
        src = bank if (i < n - 1 or n == 1) else proj
        proj = nn.conv_bn(pp, ps, src, torch.relu if i < n - 1 else None)
    h = proj + x
    if "bottleneck" in p:
        h = nn.dense(p["bottleneck"], h)
    for layer in p["highways"]:
        hw = layer["hw"]
        t = nn.dense(hw["T"], h, torch.sigmoid)
        h = nn.dense(hw["H"], h, torch.relu) * t + h * (1.0 - t)
    return nn.birnn(p["gru_fw"], p["gru_bw"], h, lengths, GRU_UNITS, lstm=False)


@torch.no_grad()
def infer(cfg, params, state, ids, lengths, steps: int):
    """(mel [N, steps * r, M], linear [N, steps * r, F]) of the
    autoregressive decode of ``steps`` steps."""
    M, r = cfg["num_mels"], cfg["outputs_per_step"]
    n, t_in = ids.shape
    x = params["embedding"]["table"][ids]
    for p in params["encoder_prenet"]["layers"]:
        x = nn.dense(p, x, torch.relu)
    memory = cbhg(params["encoder_cbhg"], state["encoder_cbhg"], x, lengths)
    keys = mm(memory, params["attention"]["memory_layer"]["kernel"])
    mask = (torch.arange(t_in, device=ids.device)[None, :]
            < torch.clamp(lengths, min=1)[:, None])
    att = params["attention"]
    z = lambda d: torch.zeros(n, d, device=ids.device)    # noqa: E731
    h1, ctx, h2, h3 = (z(cfg["attention_dim"]), z(2 * GRU_UNITS),
                       z(cfg["decoder_dim"]), z(cfg["decoder_dim"]))
    frame = z(M)
    outs = []
    for _ in range(steps):
        pre = torch.cat([frame, ctx], dim=-1)
        for p in params["decoder_prenet"]["layers"]:
            pre = nn.dense(p, pre, torch.relu)
        h1 = nn.gru_cell(params["attn_gru"], pre, h1)
        energy = torch.tanh(keys + mm(h1, att["query_layer"]["kernel"])[:, None, :])
        align = torch.softmax(mm(energy, att["v"]).masked_fill(~mask, float("-inf")), -1)
        ctx = mm(align[:, None, :], memory)[:, 0]
        proj = nn.dense(params["out_proj"], torch.cat([h1, ctx], dim=-1))
        h2 = nn.gru_cell(params["gru2"], proj, h2)
        o2 = proj + h2
        h3 = nn.gru_cell(params["gru3"], o2, h3)
        out = nn.dense(params["frame_proj"], o2 + h3)
        outs.append(out)
        frame = out[:, -M:]
    mel = torch.stack(outs, dim=1).reshape(n, steps * r, M)
    post = cbhg(params["post_cbhg"], state["post_cbhg"], mel, None)
    return mel, nn.dense(params["linear_proj"], post)
