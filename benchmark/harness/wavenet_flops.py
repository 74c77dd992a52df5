"""Operation count of one WaveNet train step, frozen with the benchmark so
that a change to the program cannot move ``mfu.wavenet_train``.

A window of the receptive field + ``sample_size`` samples scores its
last ``sample_size`` samples. Each layer computes the positions that the
scored samples need of it: a layer with later layers of dilations d_k
computes ``sample_size`` + sum(d_k (filter_width - 1)) positions, the
last one ``sample_size``. At each such position a layer's filter and
gate take ``filter_width`` x R inputs and the conditioning's M to 2 DC
outputs, and its dense product DC to R (not the last layer's, whose
residual nothing reads); its skip product (DC to S) and the head (S to S,
S to Q) run at the scored samples only. The input's causal convolution
over the one-hot codes is a lookup and counts nothing, as in the
sampler's count (``flops.sampler_sample_flops``). Products count 2mkn;
the backward counts twice the forward (the input's and the weight's
gradient); elementwise work, the loss and the optimizer count nothing.
At the recipe's widths the forward is 3.45 MFLOP per scored sample plus
the layers' extra positions."""

from __future__ import annotations


def forward_flops(wcfg) -> int:
    """Forward FLOPs of one window."""
    fw, n = wcfg["filter_width"], wcfg["sample_size"]
    R, DC, S, Q = (wcfg["residual_channels"], wcfg["dilation_channels"],
                   wcfg["skip_channels"], wcfg["quantization_channels"])
    M = wcfg["lc_channels"]
    dilations = [2 ** i for _ in range(wcfg["dilations_depth"])
                 for i in range(wcfg["dilations_length"])]
    later = sum(dilations) * (fw - 1)
    total = 0
    for k, d in enumerate(dilations):
        later -= d * (fw - 1)
        positions = n + later
        total += 2 * positions * (fw * R + M) * 2 * DC
        if k < len(dilations) - 1:
            total += 2 * positions * DC * R
        total += 2 * n * DC * S
    return total + 2 * n * (S * S + S * Q)


def train_step_flops(wcfg, batch: int) -> int:
    """FLOPs of one train step over ``batch`` windows: forward and
    backward."""
    return 3 * batch * forward_flops(wcfg)
