"""The collectives of a data-parallel training step, and the rank its
forward runs on.

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
