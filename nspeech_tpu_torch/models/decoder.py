"""Autoregressive decode with early stop for Tacotron-2 inference.

Port of ``scan_autoregressive``, ``start_autoregressive``,
``scan_autoregressive_chunk`` and the output assembly of
``nspeech_tpu/models/decoder.py``. The decode is step 0
(:func:`start_autoregressive`) followed by fixed-length chunks
(:func:`scan_autoregressive_chunk`); the stream decodes chunk by chunk.
The JAX package's one-shot decode runs a ``lax.while_loop`` that exits
once every row has stopped; here :func:`scan_autoregressive` asks the
device whether every row has stopped only once per ``check_every``-step
chunk (each ask is a host sync). A chunk that runs past the exit emits
what the reference's untouched buffers hold there, zeros, so the buffers
equal the reference's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def _device(tree) -> torch.device:
    """The device of the first tensor in a nested tuple/list."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    return _device(next(iter(tree)))


def _stopped(out: torch.Tensor, stop_threshold: float) -> torch.Tensor:
    return torch.all(out.abs() <= stop_threshold, dim=-1)


def start_autoregressive(
    step: Callable,         # (carry, x [N, M]) -> (carry, (out [N, r*M], align [N, T_in]))
    carry0,
    batch: int,
    num_mels: int,
    max_iters: int,
    stop_threshold: float = 0.0,
    initial_finished: Optional[torch.Tensor] = None,
):
    """Step 0 of the decode; returns ``((out0, align0), carry)`` with
    ``carry = (t, cell, x, finished [N] bool, steps [N] int32)`` for
    :func:`scan_autoregressive_chunk`. The first input is the all-zero GO
    frame. Rows of ``initial_finished`` (batch padding) emit zeros and
    count 0 steps; ``max_iters`` is the ``steps`` of a row that never
    stops."""
    device = _device(carry0)
    if initial_finished is None:
        initial_finished = torch.zeros(batch, dtype=torch.bool, device=device)
    cell, (out, align) = step(carry0, torch.zeros(batch, num_mels, device=device))
    out = torch.where(initial_finished[:, None], torch.zeros_like(out), out)
    stop = _stopped(out, stop_threshold)
    steps = torch.where(initial_finished, 0,
                        torch.where(stop, 1, max_iters)).to(torch.int32)
    return (out, align), (1, cell, out[:, -num_mels:], initial_finished | stop,
                          steps)


def scan_autoregressive_chunk(step: Callable, carry, k: int, num_mels: int,
                              stop_threshold: float = 0.0):
    """Exactly ``k`` decode steps from a :func:`start_autoregressive`
    carry; returns ``((outs [k, N, r*M], aligns [k, N, T_in]), carry)``.

    A row stops at the first step whose every output value has |x| <=
    ``stop_threshold``; ``steps`` counts its steps up to and including
    that one. Rows that stopped at an earlier step emit zeros (the cell
    state keeps evolving), and once every row has stopped the alignments
    are zeros too, so chained chunks equal the reference's one-shot
    buffers."""
    t, cell, x, finished, steps = carry
    outs, aligns = [], []
    for _ in range(k):
        all_done = finished.all()   # before this step: the reference's exit
        cell, (out, align) = step(cell, x)
        out = torch.where(finished[:, None], torch.zeros_like(out), out)
        align = torch.where(all_done, torch.zeros_like(align), align)
        now = _stopped(out, stop_threshold)
        steps = torch.where(~finished & now, t + 1, steps).to(torch.int32)
        finished = finished | now
        x = out[:, -num_mels:]
        outs.append(out)
        aligns.append(align)
        t += 1
    return ((torch.stack(outs), torch.stack(aligns)),
            (t, cell, x, finished, steps))


def scan_autoregressive(
    step: Callable,
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
    steps [N] int32): :func:`start_autoregressive`, then chunks of
    ``check_every`` steps until every row has stopped or ``max_iters``
    steps ran; the steps never run are zeros (see the chunk's rules)."""
    (out, align), carry = start_autoregressive(
        step, carry0, batch, num_mels, max_iters, stop_threshold,
        initial_finished)
    outs = out.new_zeros((max_iters,) + tuple(out.shape))
    aligns = align.new_zeros((max_iters,) + tuple(align.shape))
    outs[0] = out
    aligns[0] = align
    t = 1
    while t < max_iters and not bool(carry[3].all()):
        k = min(check_every, max_iters - t)
        (o, a), carry = scan_autoregressive_chunk(step, carry, k, num_mels,
                                                  stop_threshold)
        outs[t:t + k] = o
        aligns[t:t + k] = a
        t += k
    return outs, aligns, carry[4]


def assemble_outputs(outs: torch.Tensor, num_mels: int) -> torch.Tensor:
    """[S, N, r*M] decoder outputs -> [N, S*r, M] mel frames."""
    s, n, rm = outs.shape
    return outs.transpose(0, 1).reshape(n, s * (rm // num_mels), num_mels)


def assemble_alignments(aligns: torch.Tensor) -> torch.Tensor:
    """[S, N, T_in] -> [N, T_in, S]."""
    return aligns.permute(1, 2, 0)
