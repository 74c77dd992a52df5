"""The Tacotron decoders' loops: teacher forcing for training, and the
autoregressive decode with early stop for inference.

Port of ``nspeech_tpu/models/decoder.py``: :func:`teacher_frames` and
:func:`scan_teacher` (with scheduled sampling), the guided-attention
penalty, ``scan_autoregressive``, ``start_autoregressive``,
``scan_autoregressive_chunk`` and the output assembly. The teacher-forced
loop is a Python loop over the S decoder steps, differentiated by
autograd. The autoregressive decode is step 0
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
import torch.utils._pytree as pytree

from nspeech_tpu_torch.utils.tree import tree_leaves


def _device(tree) -> torch.device:
    """The device of the first tensor in a nested tuple/list."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    return _device(next(iter(tree)))


def _float_dtype(carry) -> torch.dtype:
    """The decode's compute dtype, read off the carry's first float leaf
    (the GO frame takes it; torch's default without one)."""
    return next((t.dtype for t in tree_leaves(carry) if t.is_floating_point()),
                None)


def teacher_frames(mel_targets: torch.Tensor, r: int) -> torch.Tensor:
    """[N, T_out, M] -> decoder inputs [S, N, M], S = T_out / r: step s
    reads target frame s*r - 1 (every r-th frame), step 0 a zero GO
    frame."""
    frames = mel_targets[:, r - 1::r, :]
    shifted = torch.cat([torch.zeros_like(frames[:, :1]), frames[:, :-1]], dim=1)
    return shifted.transpose(0, 1)


def scan_teacher(step: Callable, carry0, inputs: torch.Tensor,
                 sampling_ratio: float = 0.0,
                 generator: Optional[torch.Generator] = None):
    """Teacher-forced decode over ``inputs`` [S, N, M]; ``step`` is
    ``(carry, x) -> (carry, (out [N, r*M], align [N, T_in]))``. Returns
    (outputs [S, N, r*M], alignments [S, N, T_in]).

    ``sampling_ratio`` > 0 is scheduled sampling: at each step each row
    feeds its own previous predicted frame in place of the teacher frame
    with that probability (a Bernoulli draw from ``generator``). The
    fed-back frame is detached, as the JAX package's ``stop_gradient``.

    The loop also serves deferred weight gradients (``ops/deferred.py``):
    the JAX package needs ``scan_teacher_deferred`` to thread per-step
    injections through ``lax.scan``; here a deferred ``step`` taps its
    products into an ``ops.deferred.Taps``, which counts the steps."""
    num_mels = inputs.shape[-1]
    carry = carry0
    prev = torch.zeros_like(inputs[0])   # step 0's teacher input is GO
    outs, aligns = [], []
    for x in inputs:
        if sampling_ratio > 0.0:
            use_model = torch.rand(x.shape[0], generator=generator,
                                   device=x.device) < sampling_ratio
            x = torch.where(use_model[:, None], prev.detach(), x)
        carry, (out, align) = step(carry, x)
        prev = out[:, -num_mels:]
        outs.append(out)
        aligns.append(align)
    return torch.stack(outs), torch.stack(aligns)


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
    go = torch.zeros(batch, num_mels, device=device, dtype=_float_dtype(carry0))
    cell, (out, align) = step(carry0, go)
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


def while_autoregressive(
    step: Callable,
    carry0,
    batch: int,
    num_mels: int,
    r: int,
    max_iters: int,
    stop_threshold: float = 0.0,
    initial_finished: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`scan_autoregressive` as one ``while_loop`` (the counterpart
    of the JAX package's ``lax.while_loop`` decode), which ``torch.export``
    traces: the step counter is a tensor, each step writes its output and
    alignment into row t of preallocated [max_iters, N, ...] buffers with
    ``index_copy``, and the loop exits once every row has stopped, so the
    host never asks. Returns what :func:`scan_autoregressive` returns, bit
    for bit (the rows never run stay zeros)."""
    from torch._higher_order_ops import while_loop

    (out, align), (_, cell, x, finished, steps) = start_autoregressive(
        step, carry0, batch, num_mels, max_iters, stop_threshold,
        initial_finished)
    outs = torch.cat([out[None], out.new_zeros((max_iters - 1,) + tuple(out.shape))])
    aligns = torch.cat([align[None],
                        align.new_zeros((max_iters - 1,) + tuple(align.shape))])
    cell_leaves, spec = pytree.tree_flatten(cell)
    t = torch.ones((), dtype=torch.int64, device=out.device)
    # the loop's carry keeps its layout from step to step: contiguous
    x = x.contiguous()

    def cond(t, x, finished, steps, outs, aligns, *cell):
        return (t < max_iters) & ~finished.all()

    def body(t, x, finished, steps, outs, aligns, *cell):
        cell, (out, align) = step(pytree.tree_unflatten(list(cell), spec), x)
        out = torch.where(finished[:, None], torch.zeros_like(out), out)
        now = _stopped(out, stop_threshold)
        steps = torch.where(~finished & now, t + 1, steps).to(torch.int32)
        row = t.reshape(1)
        return (t + 1, out[:, -num_mels:].contiguous(), finished | now, steps,
                outs.index_copy(0, row, out[None]),
                aligns.index_copy(0, row, align[None]),
                *pytree.tree_leaves(cell))

    _, _, _, steps, outs, aligns, *_ = while_loop(
        cond, body, (t, x, finished, steps, outs, aligns, *cell_leaves))
    return outs, aligns, steps


def assemble_outputs(outs: torch.Tensor, num_mels: int) -> torch.Tensor:
    """[S, N, r*M] decoder outputs -> [N, S*r, M] mel frames."""
    s, n, rm = outs.shape
    return outs.transpose(0, 1).reshape(n, s * (rm // num_mels), num_mels)


def assemble_alignments(aligns: torch.Tensor) -> torch.Tensor:
    """[S, N, T_in] -> [N, T_in, S]."""
    return aligns.permute(1, 2, 0)


def guided_attention_penalty(alignments: torch.Tensor,
                             input_lengths: torch.Tensor,
                             out_steps: torch.Tensor,
                             sigma: float) -> torch.Tensor:
    """Guided-attention penalty (Tachibana et al. 2017): the mean over
    valid (input, decoder-step) cells of ``A[t, s] * (1 - exp(-(t/T -
    s/S)^2 / (2 sigma^2)))`` for alignments [N, T_in, S]."""
    n, t_in, s = alignments.shape
    dev = alignments.device
    t = torch.arange(t_in, device=dev)[None, :, None]
    u = torch.arange(s, device=dev)[None, None, :]
    t_norm = t / torch.clamp(input_lengths, min=1)[:, None, None]
    s_norm = u / torch.clamp(out_steps, min=1)[:, None, None]
    w = 1.0 - torch.exp(-((t_norm - s_norm) ** 2) / (2.0 * sigma * sigma))
    valid = ((t < input_lengths[:, None, None])
             & (u < out_steps[:, None, None]))
    return torch.sum(alignments * w * valid) / torch.clamp(valid.sum(), min=1)


def maybe_guided_attention(cfg, alignments, input_lengths, mel_targets,
                           is_training: bool):
    """The penalty above when training with ``guided_attention_weight`` >
    0, else None. A row's decoder steps run to its LAST voiced target
    frame (an interior all-zero frame does not shorten it)."""
    if not (is_training and cfg.get("guided_attention_weight", 0.0) > 0.0):
        return None
    voiced = torch.any(mel_targets != 0.0, dim=-1)
    t_out = mel_targets.shape[1]
    frame = torch.arange(t_out, device=mel_targets.device)[None, :]
    last = torch.max(torch.where(voiced, frame, -1), dim=-1).values
    out_steps = torch.ceil((last + 1) / cfg.outputs_per_step).to(torch.int32)
    return guided_attention_penalty(alignments, input_lengths, out_steps,
                                    cfg.get("guided_attention_sigma", 0.2))


def apply_guided_loss(cfg, outputs, loss, metrics):
    """Add the weighted guided penalty (when the forward computed one) to
    ``loss`` and record it in ``metrics``; shared by both Tacotrons."""
    if "guided_attention" in outputs:
        ga = outputs["guided_attention"]
        loss = loss + cfg.guided_attention_weight * ga
        metrics["loss_guided_attention"] = ga
    return loss
