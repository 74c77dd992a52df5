"""Operation counts and peaks: the yardstick of every share of a peak or
a roofline, frozen here so that a change to the program cannot move it.

Products count 2mkn FLOPs; in a train step also 2mkn for the weight's
gradient and 2mkn for the input's where the input carries one
(:func:`taco2_train_flops`, a copy of the port's ``taco2_flop_terms``
as it stood when the benchmark was defined). Elementwise work counts
nothing. The peaks are NVIDIA's for the H100 SXM part, dense: the
configurations run in float32 with TF32 off, so every share is taken
against 67 TFLOP/s and 3.35 TB/s."""

from __future__ import annotations

import math
from typing import Dict

PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 67e12}       # float32, TF32 off
PEAK_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12}

LOCATION_FILTERS, LOCATION_KERNEL = 20, 7


def peaks(card: str):
    """(FLOP/s, bytes/s) of ``card``; a card the table lacks raises."""
    if card not in PEAK_FLOPS:
        raise KeyError(f"no float32 peak for card {card!r} in "
                       "benchmark/harness/flops.py")
    return PEAK_FLOPS[card], PEAK_BYTES[card]


def _product(m, k, n, dx=True):
    return 2 * m * k * n * (3 if dx else 2)


def _conv_stack(rows, in_ch, layers, width, channels):
    total = 0
    for _ in range(layers):
        total += _product(rows, width * in_ch, channels)
        in_ch = channels
    return total


def _bilstm(batch, steps, in_ch, units):
    rec = 2 * (2 * batch) * units * (4 * units)
    return _product(2 * batch * steps, in_ch, 4 * units) + rec * (3 * steps - 1)


def taco2_flop_terms(cfg, batch_size: int, t_in: int, t_out: int) -> Dict[str, int]:
    """FLOPs of the products and convolutions of one Tacotron-2 train step
    over a [batch_size, t_in] text and t_out teacher frames, by part."""
    r = int(cfg["outputs_per_step"])
    if t_out % r:
        raise ValueError(f"t_out={t_out} is not a multiple of r={r}")
    B, T, S = batch_size, t_in, t_out // r
    M, A, D = cfg["num_mels"], cfg["attention_dim"], cfg["decoder_lstm_units"]
    Dm = 2 * cfg["encoder_lstm_units"]
    attn_in = 128
    terms = {}
    if cfg["num_speakers"] > 1:
        terms["speaker_prenet"] = _product(B, cfg["speaker_embed_dim"], 128)
        attn_in += 128
    terms["encoder_convs"] = _conv_stack(B * T, cfg["embedding_dim"],
                                         cfg["encoder_conv_layers"],
                                         cfg["encoder_conv_width"],
                                         cfg["encoder_conv_channels"])
    terms["encoder_lstm"] = _bilstm(B, T, cfg["encoder_conv_channels"],
                                    cfg["encoder_lstm_units"])
    terms["attention_memory"] = _product(B * T, Dm, A)
    terms["decoder_prenet"] = (_product(B, M + Dm, 256, dx=False)
                               + (S - 1) * _product(B, M + Dm, 256)
                               + S * _product(B, 256, 128))
    terms["decoder_lstms"] = S * (_product(B, attn_in + A, 4 * A)
                                  + _product(B, A + Dm + D, 4 * D)
                                  + _product(B, 2 * D, 4 * D))
    terms["attention_query"] = S * _product(B, A, A)
    terms["attention_location"] = (
        _product(B * T, LOCATION_KERNEL, LOCATION_FILTERS, dx=False)
        + (S - 1) * _product(B * T, LOCATION_KERNEL, LOCATION_FILTERS)
        + S * _product(B * T, LOCATION_FILTERS, A))
    terms["attention_score"] = S * _product(B * T, A, 1)
    terms["attention_context"] = S * _product(B, T, Dm)
    terms["frame_proj"] = S * _product(B, D, M * r)
    P = cfg["postnet_conv_channels"]
    terms["postnet"] = (_conv_stack(B * t_out, M, cfg["postnet_conv_layers"],
                                    cfg["postnet_conv_width"], P)
                        + _product(B * t_out, P, M))
    terms["expand_convs"] = _conv_stack(B * t_out, M, cfg["expand_conv_layers"],
                                        cfg["expand_conv_width"],
                                        cfg["expand_conv_channels"])
    terms["expand_lstm"] = _bilstm(B, t_out, cfg["expand_conv_channels"],
                                   cfg["expand_lstm_units"])
    terms["linear_proj"] = _product(B * t_out, 2 * cfg["expand_lstm_units"],
                                    cfg["num_freq"])
    return terms


def taco2_train_flops(cfg, t_in: int, t_out: int) -> int:
    """One row's share of a train step at its own unpadded lengths (t_out
    rounded up to a multiple of r): the step's count is linear in the
    batch, so rows sum."""
    r = int(cfg["outputs_per_step"])
    return sum(taco2_flop_terms(cfg, 1, t_in, -(-t_out // r) * r).values())


def taco2_serve_flops(cfg, t_in: int, steps: int) -> int:
    """Forward FLOPs of one row of Tacotron-2 inference up to the mel:
    encoder, ``steps`` decoder steps, the postnet over steps * r frames."""
    M, A, D = cfg["num_mels"], cfg["attention_dim"], cfg["decoder_lstm_units"]
    He, r = cfg["encoder_lstm_units"], cfg["outputs_per_step"]
    Dm = 2 * He
    C, W = cfg["encoder_conv_channels"], cfg["encoder_conv_width"]
    f = 2 * t_in * W * cfg["embedding_dim"] * C
    f += (cfg["encoder_conv_layers"] - 1) * 2 * t_in * W * C * C
    f += 2 * 2 * t_in * (C + He) * 4 * He                      # BiLSTM
    f += 2 * t_in * Dm * A                                      # memory layer
    step = (2 * (M + Dm) * 256 + 2 * 256 * 128
            + 2 * (128 + A) * 4 * A + 2 * (A + Dm + D) * 4 * D + 2 * 2 * D * 4 * D
            + 2 * A * A + 2 * t_in * (LOCATION_KERNEL * LOCATION_FILTERS
                                      + LOCATION_FILTERS * A + A + Dm)
            + 2 * D * M * r)
    f += steps * step
    T, P, Wp = steps * r, cfg["postnet_conv_channels"], cfg["postnet_conv_width"]
    f += 2 * T * Wp * (M * P + (cfg["postnet_conv_layers"] - 1) * P * P) + 2 * T * P * M
    return f


def taco1_serve_flops(cfg, t_in: int, steps: int) -> int:
    """Forward FLOPs of one row of Tacotron-1 inference to the linear
    spectrogram: encoder prenet and CBHG, ``steps`` decoder steps, the
    post-CBHG and the projection over steps * r frames."""
    M, r, A, Dd = (cfg["num_mels"], cfg["outputs_per_step"],
                   cfg["attention_dim"], cfg["decoder_dim"])
    E, pre = cfg["embedding_dim"], cfg["encoder_prenet"]
    f = 2 * t_in * (E * pre[0] + pre[0] * pre[1])
    f += _cbhg(t_in, pre[-1], cfg["encoder_cbhg_banks"],
               list(cfg["encoder_cbhg_bank_sizes"]))
    Dm = 256
    f += 2 * t_in * Dm * A
    gru = lambda i, u: 2 * (i + u) * 3 * u                        # noqa: E731
    step = (2 * (M + Dm) * 256 + 2 * 256 * 128 + gru(128, A) + 2 * A * A
            + 2 * t_in * (A + Dm) + 2 * (A + Dm) * Dd + 2 * gru(Dd, Dd)
            + 2 * Dd * M * r)
    f += steps * step
    T = steps * r
    f += _cbhg(T, M, cfg["post_cbhg_banks"], list(cfg["post_cbhg_bank_sizes"]) + [M])
    f += 2 * T * 256 * cfg["num_freq"]
    return f


def _cbhg(T, in_dim, K, proj):
    f = sum(2 * T * k * in_dim * 128 for k in range(1, K + 1))
    n = len(proj)
    for i, size in enumerate(proj):
        c_in = 128 * K if (i < n - 1 or n == 1) else proj[n - 2]
        f += 2 * T * 3 * c_in * size
    if in_dim != 128:
        f += 2 * T * in_dim * 128
    f += 4 * 2 * 2 * T * 128 * 128                              # highways
    f += 2 * 2 * T * (128 + 128) * 3 * 128                      # BiGRU
    return f


def griffin_lim_flops(cfg, frames: int) -> int:
    """5 N log2 N per FFT of size N = n_fft: one inverse to start, then a
    forward and an inverse per iteration, one per frame."""
    n_fft = (cfg["num_freq"] - 1) * 2
    per = 5 * n_fft * math.log2(n_fft)
    return int(frames * per * (1 + 2 * cfg["griffin_lim_iters"]))


def sampler_sample_flops(wcfg) -> int:
    """The WaveNet sampler's FLOPs per sample and stream: 2 x (L x ((2R +
    M) 2DC + DC R + DC S) + S^2 + S Q), 3.45 MFLOP at the recipe's
    widths with lc 80."""
    L = wcfg["dilations_depth"] * wcfg["dilations_length"]
    R, DC, S, Q = (wcfg["residual_channels"], wcfg["dilation_channels"],
                   wcfg["skip_channels"], wcfg["quantization_channels"])
    M = wcfg["lc_channels"]
    return 2 * (L * ((2 * R + M) * 2 * DC + DC * R + DC * S) + S * S + S * Q)


def sampler_launch_bytes(wcfg, streams: int, samples: int) -> int:
    """Bytes a sampler launch must move once: its weights, each stream's
    conditioning and codes, and its carried rings in and out."""
    L = wcfg["dilations_depth"] * wcfg["dilations_length"]
    R, DC, S, Q = (wcfg["residual_channels"], wcfg["dilation_channels"],
                   wcfg["skip_channels"], wcfg["quantization_channels"])
    M = wcfg["lc_channels"]
    weights = 4 * (2 * Q * R + L * ((2 * R + M) * 2 * DC + DC * R + DC * S) + S * S + S * Q)
    rings = 2 * 4 * sum(2 ** i for _ in range(wcfg["dilations_depth"])
                        for i in range(wcfg["dilations_length"])) * R
    return weights + streams * (samples * 4 * (M + 1) + rings)
