"""Plain WaveNet vocoder (van den Oord et al. 2016, arXiv:1609.03499;
Shen et al. 2018's mel conditioning) at the repo's recipe
(``hparams/wavenet.yaml`` with lc_channels = 80): one-hot mu-law input,
a width-2 causal convolution to R channels, L layers of width-2 dilated
causal convolutions (dilations 1..2^(len-1), repeated) whose filter and
gate add the local conditioning through 1x1 products, the gated
activation tanh(f) * sigmoid(g), a 1x1 dense back to R added to the
residual, a 1x1 skip to S, then ReLU, 1x1 (S), ReLU, 1x1 (Q) logits.
No biases (use_biases = False), no speakers.

:func:`logits` is the teacher-forced network over a stream's input codes
(the silence code Q // 2, then each emitted code), with zeros before the
first sample in every layer, which is the generator's empty state.
:func:`gumbel` is a frozen copy of the served sampler's noise (Philox
4x32-10): code q of row b at sample t takes word q % 4 of philox(counter
= (q // 4, t, b, 0), key = the 64-bit seed), u = (bits >> 8) * 2^-24 +
1e-10, g = -log(-log(u)). A served code at temperature T is argmax
(logits / T + g)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import mm


def dilations(cfg):
    return [2 ** i for _ in range(cfg["dilations_depth"])
            for i in range(cfg["dilations_length"])]


def param_shapes(cfg):
    R, DC, S, Q = (cfg["residual_channels"], cfg["dilation_channels"],
                   cfg["skip_channels"], cfg["quantization_channels"])
    M = cfg["lc_channels"]
    if cfg["use_biases"] or cfg["gc_channels"] or cfg["scalar_input"] or cfg["filter_width"] != 2:
        raise ValueError("reference WaveNet: width-2 one-hot, no biases, no gc")

    def conv(w, i, o):
        return ((w, i, o), ("glorot", w * i, w * o))

    layer = {"filter": conv(2, R, DC), "gate": conv(2, R, DC),
             "dense": conv(1, DC, R), "skip": conv(1, DC, S)}
    if M:
        layer.update({"lc_filter": conv(1, M, DC), "lc_gate": conv(1, M, DC)})
    return {"causal": conv(2, Q, R),
            "layers": [dict(layer) for _ in dilations(cfg)],
            "post1": conv(1, S, S), "post2": conv(1, S, Q)}


def _shift(x, d):
    """x [T, C] delayed by d samples (zeros before the start)."""
    return F.pad(x, (0, 0, d, 0))[: x.shape[0]]


@torch.no_grad()
def logits(cfg, params, inputs: torch.Tensor, lc) -> torch.Tensor:
    """Input codes [T] (int) and conditioning [T, M] -> logits [T, Q]."""
    Q = cfg["quantization_channels"]
    x = torch.nn.functional.one_hot(inputs.long(), Q).float()
    w = params["causal"]
    cur = mm(_shift(x, 1), w[0]) + mm(x, w[1])
    skip = 0.0
    for lp, d in zip(params["layers"], dilations(cfg)):
        past = _shift(cur, d)
        f = mm(past, lp["filter"][0]) + mm(cur, lp["filter"][1])
        g = mm(past, lp["gate"][0]) + mm(cur, lp["gate"][1])
        if lc is not None:
            f = f + mm(lc, lp["lc_filter"][0])
            g = g + mm(lc, lp["lc_gate"][0])
        out = torch.tanh(f) * torch.sigmoid(g)
        skip = skip + mm(out, lp["skip"][0])
        cur = cur + mm(out, lp["dense"][0])
    h = mm(torch.relu(skip), params["post1"][0])
    return mm(torch.relu(h), params["post2"][0])


_M0, _M1, _W0, _W1, _MASK = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, 0xFFFFFFFF


def _mulhilo(m, a):
    x, y = m * (a >> 16), m * (a & 0xFFFF)
    return (x + (y >> 16)) >> 16, (((x & 0xFFFF) << 16) + y) & _MASK


def gumbel(seed: int, t: torch.Tensor, row: int, q: int) -> torch.Tensor:
    """Noise [len(t), q] of batch row ``row`` at sample indices ``t``."""
    j = torch.arange(q // 4, dtype=torch.int64, device=t.device)[None, :]
    shape = (t.shape[0], q // 4)
    c0, c1 = j.expand(shape), (t.long() & _MASK)[:, None].expand(shape)
    c2 = torch.full(shape, row, dtype=torch.int64, device=t.device)
    c3 = torch.zeros(shape, dtype=torch.int64, device=t.device)
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    bits = torch.stack([c0, c1, c2, c3], dim=-1).reshape(t.shape[0], q)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-10
    return -torch.log(-torch.log(u))

