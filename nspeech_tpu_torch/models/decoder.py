"""Autoregressive decode with early stop for Tacotron-2 inference.

Port of ``scan_autoregressive`` and the output assembly of
``nspeech_tpu/models/decoder.py``. The JAX package runs a
``lax.while_loop`` that exits once every row has stopped; here a Python
loop asks the device whether every row has stopped only every
``check_every`` steps (each ask is a host sync), and the steps run past
the exit are then zeroed, so the buffers equal the reference's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def _device(tree) -> torch.device:
    """The device of the first tensor in a nested tuple/list."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    return _device(next(iter(tree)))


def scan_autoregressive(
    step: Callable,         # (carry, x [N, M]) -> (carry, (out [N, r*M], align [N, T_in]))
    carry0,
    batch: int,
    num_mels: int,
    r: int,
    max_iters: int,
    stop_threshold: float = 0.0,
    initial_finished: Optional[torch.Tensor] = None,
    check_every: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (outputs [max_iters, N, r*M], alignments [max_iters, N, T_in],
    steps [N] int32).

    A row stops at the first step whose every output value has |x| <=
    ``stop_threshold``; ``steps`` counts its steps up to and including that
    one (``max_iters`` if it never stops, 0 for rows of
    ``initial_finished``). Frames of rows that stopped at an earlier step,
    and of ``initial_finished`` rows, are zeros; the cell state keeps
    evolving. The first input is the all-zero GO frame."""
    device = _device(carry0)
    x0 = torch.zeros(batch, num_mels, device=device)
    if initial_finished is None:
        initial_finished = torch.zeros(batch, dtype=torch.bool, device=device)

    def stopped(out):
        return torch.all(out.abs() <= stop_threshold, dim=-1)

    carry, (out, align) = step(carry0, x0)
    out = torch.where(initial_finished[:, None], torch.zeros_like(out), out)
    outs = out.new_zeros((max_iters,) + tuple(out.shape))
    aligns = align.new_zeros((max_iters,) + tuple(align.shape))
    outs[0] = out
    aligns[0] = align
    stop = stopped(out)
    finished = initial_finished | stop
    steps = torch.where(initial_finished, 0,
                        torch.where(stop, 1, max_iters)).to(torch.int32)
    x = out[:, -num_mels:]
    for t in range(1, max_iters):
        if (t - 1) % check_every == 0 and bool(finished.all()):
            break
        carry, (out, align) = step(carry, x)
        out = torch.where(finished[:, None], torch.zeros_like(out), out)
        outs[t] = out
        aligns[t] = align
        now = stopped(out)
        steps = torch.where(~finished & now, t + 1, steps).to(torch.int32)
        finished = finished | now
        x = out[:, -num_mels:]
    # The reference exits before the step after the last row stopped:
    # zero what this loop ran past that point.
    t_stop = torch.where(finished.all(), steps.max().clamp(min=1),
                         torch.tensor(max_iters, device=device))
    keep = torch.arange(max_iters, device=device) < t_stop
    outs = outs * keep[:, None, None]
    aligns = aligns * keep[:, None, None]
    return outs, aligns, steps


def assemble_outputs(outs: torch.Tensor, num_mels: int) -> torch.Tensor:
    """[S, N, r*M] decoder outputs -> [N, S*r, M] mel frames."""
    s, n, rm = outs.shape
    return outs.transpose(0, 1).reshape(n, s * (rm // num_mels), num_mels)


def assemble_alignments(aligns: torch.Tensor) -> torch.Tensor:
    """[S, N, T_in] -> [N, T_in, S]."""
    return aligns.permute(1, 2, 0)
