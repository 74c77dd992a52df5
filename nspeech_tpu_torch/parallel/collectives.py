"""The collectives of a data-parallel and a tensor-parallel training
step, and the ranks its forward runs on.

Under GSPMD a JAX step sharded over the batch computes what the plain
step computes on the whole batch: batch-norm moments, a loss whose
denominator depends on the data, and random draws are all global. Here
each rank runs the plain step on its rows, inside :func:`data_parallel`,
and the few places that would otherwise be local read :func:`current`:

- training batch norm (``ops/layers.py``) all-reduces its sums and its
  centred second moments through :func:`all_reduce_sum`, which is
  differentiable, so the backward sees the global statistics too;
- the guided-attention penalty (``models/decoder.py``) all-reduces its
  denominator;
- dropout and scheduled sampling draw at the global batch's shape from
  the step's generator and keep this rank's rows (:func:`rand_rows`).

After the backward pass :func:`average_grads` and
:func:`average_metrics` average over the ranks (the loss terms are means
over equal shapes on every rank, so their average is the global mean).
Outside :func:`data_parallel` nothing here runs and the step is the plain
one, bit for bit.

Inside :func:`tensor_parallel` (a ``parallel.mesh.TensorParallel``) the
layers that ``parallel/tensor.py``'s rules shard hold this rank's slice
of their weights, and the model code reads :func:`current_tp` and moves
activations between the model ranks with Megatron's three operators:
:func:`copy_to_model` in front of a column-parallel product (its input
is whole on every rank; the backward sums the ranks' partial input
gradients), :func:`reduce_from_model` after a row-parallel one (the
forward sums the ranks' partial products) and :func:`gather_from_model`
where a sharded activation becomes whole. Everything else is computed
whole on every model rank, and so is its gradient.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from nspeech_tpu_torch.utils.tree import tree_leaves, tree_map

_local = threading.local()


@contextlib.contextmanager
def data_parallel(dp):
    """Run the enclosed forward and backward as rank ``dp.rank`` of
    ``dp.world`` (a ``parallel.mesh.DataParallel``); None runs them
    plain."""
    saved = getattr(_local, "dp", None)
    _local.dp = dp
    try:
        yield
    finally:
        _local.dp = saved


def current():
    """The ``DataParallel`` of the enclosing :func:`data_parallel`, or
    None."""
    return getattr(_local, "dp", None)


@contextlib.contextmanager
def tensor_parallel(tp):
    """Run the enclosed forward and backward as rank ``tp.rank`` of the
    ``tp.world`` model ranks (a ``parallel.mesh.TensorParallel``); None
    runs them whole."""
    saved = getattr(_local, "tp", None)
    _local.tp = tp
    try:
        yield
    finally:
        _local.tp = saved


def current_tp():
    """The ``TensorParallel`` of the enclosing :func:`tensor_parallel`, or
    None."""
    return getattr(_local, "tp", None)


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model ranks; the backward passes the gradient (every
    rank reads the whole sum)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def model_slice(x: torch.Tensor, tp) -> torch.Tensor:
    """This model rank's contiguous slice of the last axis of ``x``."""
    width = x.shape[-1] // tp.world
    return x[..., tp.rank * width:(tp.rank + 1) * width]


def all_gather_last(x: torch.Tensor, tp) -> torch.Tensor:
    """The ranks' ``x`` concatenated on the last axis, in rank order (no
    gradient)."""
    x = x.contiguous()
    pieces = [torch.empty_like(x) for _ in range(tp.world)]
    dist.all_gather(pieces, x, group=tp.group)
    return torch.cat(pieces, dim=-1)


class _GatherFromModel(torch.autograd.Function):
    """All-gather on the last axis; the backward keeps this rank's
    slice."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.rank, ctx.width = tp.rank, x.shape[-1]
        return all_gather_last(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.rank * ctx.width, ctx.width), None


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The input of a column-parallel product: ``x`` itself, whose
    gradient is summed over the model ranks of ``tp``."""
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum over the model ranks of ``tp`` of their partial ``x``."""
    return _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The ranks' slices ``x`` concatenated on the last axis."""
    return _GatherFromModel.apply(x, tp)


def leaf_squares(leaves: List[torch.Tensor], sharded: List[bool], tp) -> torch.Tensor:
    """Each leaf's sum of squares in the whole tree that ``leaves`` are
    this rank's slices of: a ``sharded`` leaf's squares are summed over the
    model ranks of ``tp``, a replicated leaf's counted once (one
    all-reduce)."""
    sq = torch.stack([torch.sum(torch.square(x)) for x in leaves])
    mask = torch.tensor(sharded, dtype=torch.bool, device=sq.device)
    part = torch.where(mask, sq, torch.zeros_like(sq))
    dist.all_reduce(part, group=tp.group)
    return torch.where(mask, part, sq)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward sums the gradients over the ranks
    (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, dp) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``dp``, differentiable."""
    return _AllReduceSum.apply(x, dp.group)


def rand_rows(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's rows: inside
    :func:`data_parallel` the draw is at the global shape (``world`` times
    the rows), so W ranks draw what one device draws for the whole
    batch."""
    dp = current()
    shape = tuple(shape)
    if dp is None:
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand((shape[0] * dp.world,) + shape[1:], generator=generator,
                      device=device)
    return full[dp.rank * shape[0]:(dp.rank + 1) * shape[0]]


def global_moments(x: torch.Tensor, axes) -> tuple:
    """(mean, biased variance) of ``x`` over ``axes`` and over the ranks
    of :func:`current`: the sums and counts first, then the centred
    second moments, both all-reduced (differentiably)."""
    dp = current()
    count = x.new_full((1,), math.prod(x.shape[a] for a in axes))
    sums = all_reduce_sum(torch.cat([x.sum(dim=axes), count]), dp)
    mean = sums[:-1] / sums[-1]
    var = all_reduce_sum(((x - mean) ** 2).sum(dim=axes), dp) / sums[-1]
    return mean, var


def global_count(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of :func:`current` of a count (no
    gradient)."""
    x = x.detach().clone()
    dist.all_reduce(x, group=current().group)
    return x


def average_grads(grads, dp):
    """The mean over the ranks of a gradient tree: one all-reduce per
    dtype of the leaves flattened into one buffer (the float32 master
    gradients under the bf16 policy)."""
    leaves = tree_leaves(grads)
    out: Dict[int, torch.Tensor] = {}
    for dtype in sorted({g.dtype for g in leaves}, key=str):   # one order on every rank
        group = [g for g in leaves if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, group=dp.group)
        flat /= dp.world
        for g, piece in zip(group, torch.split(flat, [g.numel() for g in group])):
            out[id(g)] = piece.view_as(g)
    return tree_map(lambda g: out[id(g)], grads)


def average_metrics(metrics: Dict[str, torch.Tensor], dp) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each scalar metric, in one all-reduce."""
    names = sorted(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float64) for k in names])
    dist.all_reduce(flat, group=dp.group)
    flat /= dp.world
    return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(names)}


def max_over_ranks(values: List[int], dp) -> List[int]:
    """The largest of each of ``values`` over the ranks of ``dp`` (on its
    device, as NCCL needs)."""
    t = torch.tensor(values, dtype=torch.int64, device=dp.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=dp.group)
    return [int(v) for v in t.tolist()]


def barrier(dp) -> None:
    """Every rank of ``dp`` meets here (after rank 0's writes)."""
    if dp is not None:
        dist.barrier(group=dp.group)
