"""WaveNet sharded along time over the ranks of a process group: port of
``nspeech_tpu/parallel/timeshard.py``.

Rank r of W holds the r-th contiguous chunk of the sample axis of a
window of T samples (and of its per-sample conditioning) and receives its
left halo, the last ``receptive_field`` samples of rank r-1's chunk, by a
send/receive pair (the counterpart of JAX's non-circular ``ppermute``).
Rank 0 receives zeros: the feeder's left zero padding, so the sharded
computation equals the unsharded one on the zero-padded window. The
halo's backward sends its gradient back to the neighbour
(:class:`_LeftHalo`), so the sharded forward also trains
(:func:`build_time_sharded_wavenet_step`): each rank's window of
activations is T/W long, for audio windows longer than one card holds.

The functions take the global arrays, as JAX's take them, and return
this rank's chunk of the global result (JAX's ``out_specs`` over the
time axis): the global logits are the ranks' chunks in rank order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nspeech_tpu_torch.parallel import collectives


def shift(x: torch.Tensor, dp, to: int) -> torch.Tensor:
    """``x`` sent to rank ``rank + to`` and the same-shaped tensor received
    from rank ``rank - to`` (zeros where that rank does not exist): the
    non-circular permutation by ``to`` along the ranks."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= dp.rank + to < dp.world:
        ops.append(dist.P2POp(dist.isend, x, dp.rank + to, dp.group))
    if 0 <= dp.rank - to < dp.world:
        ops.append(dist.P2POp(dist.irecv, out, dp.rank - to, dp.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _LeftHalo(torch.autograd.Function):
    """The last ``h`` steps (axis 1) of the left neighbour's chunk (zeros
    on rank 0). Backward: the halo's gradient goes back to the left
    neighbour, and this rank's last ``h`` steps receive the right
    neighbour's."""

    @staticmethod
    def forward(ctx, x, h, dp):
        ctx.h, ctx.dp, ctx.shape = h, dp, x.shape
        return shift(x[:, -h:], dp, 1)

    @staticmethod
    def backward(ctx, grad):
        grad_x = grad.new_zeros(ctx.shape)
        grad_x[:, -ctx.h:] = shift(grad, ctx.dp, -1)
        return grad_x, None, None


def left_halo(x: torch.Tensor, h: int, dp) -> torch.Tensor:
    """Differentiable: the last ``h`` steps of the left neighbour's
    chunk, zeros on rank 0."""
    return _LeftHalo.apply(x, h, dp)


def _check(net, T: int, n: int) -> None:
    rf = net.receptive_field
    if T % n != 0:
        raise ValueError(f"time length {T} not divisible by {n} shards")
    if T // n < rf:
        raise ValueError(
            f"chunk {T // n} < receptive field {rf}: single-hop halo "
            "needs chunks at least as long as the receptive field")


def make_time_sharded_logits(net, dp, use_gc: bool = False,
                             use_lc: bool = False):
    """Returns fn(params, audio [B, T], gc_ids, lc [B, T, M]) -> this
    rank's chunk of (logits [B, T, Q], targets [B, T]), with T sharded
    over the ranks of ``dp`` (a ``parallel.mesh.DataParallel``).

    T must be divisible by the number of ranks, and T/W must be >= the
    receptive field (single-hop halo)."""
    n = dp.world
    rf = net.receptive_field

    def fn(params, audio, gc_ids=None, lc=None):
        T = audio.shape[1]
        _check(net, T, n)
        chunk = slice(dp.rank * (T // n), (dp.rank + 1) * (T // n))
        audio_loc = audio[:, chunk]
        window = torch.cat([left_halo(audio_loc, rf, dp), audio_loc], dim=1)
        lc_window = None
        if use_lc:
            lc_loc = lc[:, chunk]
            lc_window = torch.cat([left_halo(lc_loc, rf, dp), lc_loc], dim=1)
        return net.forward_train(params, window,
                                 gc_ids=gc_ids if use_gc else None,
                                 lc=lc_window)

    return fn


def build_time_sharded_wavenet_step(net, optimizer, dp,
                                    use_gc: bool = False, use_lc: bool = False,
                                    schedule=None, cfg=None,
                                    ema_decay: float = 0.0):
    """``step_fn(state, batch, generator=None) -> (state, metrics)`` on
    time-sharded windows: the batch and state of
    ``train/loop.py`` ``build_wavenet_train_step``, with the audio (and
    lc) time axis sharded over the ranks of ``dp`` instead of the batch
    axis: the time-sharded gradients over the train step's core
    (``train/loop.py`` ``build_train_step``, eager). Every rank passes the
    whole batch and leaves with the same state: the gradients and the
    loss are averaged over the ranks (each rank's cross-entropy is a mean
    over equal chunks). Batches in the feeder's frame-rate lc layout
    (``mel_phase`` set) are upsampled on the device first: pass ``cfg``
    (for the hop length). Metrics: ``loss``, ``grad_norm``,
    ``grad_norms`` and ``learning_rate``."""
    from nspeech_tpu_torch.ops.upsample import batch_lc
    from nspeech_tpu_torch.train.loop import autograd_grads, build_train_step, trainable

    logits_fn = make_time_sharded_logits(net, dp, use_gc, use_lc)

    def grads_fn(state, batch, generator):
        params = trainable(state.params)
        logits, targets = logits_fn(
            params, batch.audio,
            gc_ids=batch.speaker_ids if use_gc else None,
            lc=batch_lc(batch, cfg) if use_lc else None)
        loss, _ = net.loss(logits, targets)
        grads = autograd_grads(loss, params)
        with torch.no_grad():
            return (collectives.average_grads(grads, dp),
                    collectives.average_metrics({"loss": loss.detach()}, dp),
                    state.bn_state)

    return build_train_step(grads_fn, optimizer, schedule, ema_decay, graphed=False)
