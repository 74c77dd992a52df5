"""Length (sequence) sharding for Tacotron's convolutional stacks: port of
``nspeech_tpu/parallel/lengthshard.py``.

The frame (or symbol) axis is split over the ranks of a process group, as
``parallel/timeshard.py`` splits WaveNet's samples. SAME-padded convs are
not causal, so each rank exchanges a halo on BOTH sides with its
neighbours (``timeshard.shift``, a non-circular permutation each way);
the ranks at the ends receive zeros, SAME padding's own zeros, so the
sharded stack equals the unsharded one.

Halos are exchanged PER LAYER (depth ``kernel_width // 2``): one exchange
of the stack's total halo up front is not exact at the sequence ends,
where each conv + batch-norm layer of the unsharded stack re-inserts true
zeros while its bias and batch-norm offset would move a pre-padded zero
region. Per-layer exchange also only needs chunks one kernel half-width
long.

Scope, as JAX's: inference-mode stacks (batch norm from its running
statistics, which is pointwise); the long sequence this serves is
synthesis, the postnet and the conv stacks over many decoder frames.
The functions take the global [N, T, C] input and return this rank's
chunk of the global output (the ranks' chunks in rank order).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from nspeech_tpu_torch.ops import layers as L
from nspeech_tpu_torch.parallel.timeshard import shift


def _both_halos(x: torch.Tensor, h: int, dp) -> torch.Tensor:
    """[chunk] -> [left_halo | chunk | right_halo] along axis 1; the ranks
    at the ends receive zeros (SAME padding's convention)."""
    left = shift(x[:, -h:], dp, 1)
    right = shift(x[:, :h], dp, -1)
    return torch.cat([left, x, right], dim=1)


def make_length_sharded_conv_stack(
    dp,
    activation_for: Callable[[int, int], Optional[Callable]],
    out_dense: bool = False,
):
    """Builds fn(params, state, x [N, T, C]) -> this rank's chunk of y,
    with T sharded over the ranks of ``dp`` (a
    ``parallel.mesh.DataParallel``). ``params`` holds "convs" (a list of
    conv_bn layer params, and "out" with ``out_dense``);
    ``activation_for(i, n)`` picks each layer's activation. Inference
    mode (batch norm from the running statistics)."""
    n = dp.world

    @torch.no_grad()
    def fn(params, state, x):
        T = x.shape[1]
        if T % n != 0:
            raise ValueError(f"length {T} not divisible by {n} shards")
        t_loc = T // n
        y = x[:, dp.rank * t_loc:(dp.rank + 1) * t_loc]
        n_layers = len(params["convs"])
        for i, (p, s) in enumerate(zip(params["convs"], state["convs"])):
            h = p["conv"]["kernel"].shape[0] // 2
            if t_loc < h:
                raise ValueError(
                    f"chunk {t_loc} < kernel halo {h}: shard longer chunks")
            w = _both_halos(y, h, dp) if h else y
            yw = L.conv_bn(p, s, w, activation_for(i, n_layers))
            y = yw[:, h: h + t_loc] if h else yw
        if out_dense:
            y = L.dense(params["out"], y)
        return y

    return fn


def make_length_sharded_postnet(dp):
    """Length-sharded Tacotron-2 postnet (tanh convs + output dense;
    ``models/modules.py`` ``postnet``, inference mode)."""
    return make_length_sharded_conv_stack(
        dp, activation_for=lambda i, n: torch.tanh if i < n - 1 else None,
        out_dense=True)


def make_length_sharded_encoder_convs(dp):
    """Length-sharded Tacotron-2 encoder conv stack (relu convs; the BiLSTM
    that follows is sequential over time and stays unsharded)."""
    return make_length_sharded_conv_stack(
        dp, activation_for=lambda i, n: torch.relu if i < n - 1 else None,
        out_dense=False)
