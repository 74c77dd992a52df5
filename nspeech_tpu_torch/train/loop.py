"""The train steps of Tacotron and WaveNet: port of
``nspeech_tpu/train/loop.py``.

One step is the forward in training mode (teacher-forced for a Tacotron),
the loss, its gradients by autograd, the clip and Adam update of
``train/optim.py``, and the EMA of the parameters after the update. The
Tacotron step defers the weight gradients of the products inside its
loops by default, as the JAX package's does (``ops/deferred.py``):
autograd alone forms and adds a full-size weight gradient at every
decoder step. A feeder batch (numpy) reaches the device through pinned
host memory; a batch already on the device (``data/device_cache.py``)
passes through. With a ``parallel.mesh.DataParallel`` (``dp``) a step
is the data-parallel one: each rank runs the plain step on its rows and
leaves with the plain step's result on the global batch. With a
``parallel.mesh.TensorParallel`` (``tp``) the Tacotron step is also
tensor-parallel: the state holds this model rank's slices
(``parallel/tensor.py`` ``shard_train_state``) and the step leaves with
this rank's slices of the plain step's result.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from nspeech_tpu_torch.parallel import collectives
from nspeech_tpu_torch.parallel.tensor import sharded_leaves
from nspeech_tpu_torch.train.optim import apply_updates, global_norm
from nspeech_tpu_torch.utils.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    step: int
    params: Any
    bn_state: Any
    opt_state: Any
    # Polyak/EMA average of params when cfg.ema_decay > 0, else None
    ema_params: Any = None


class TacotronBatch(NamedTuple):
    """A feeder batch as tensors on the training device."""
    inputs: torch.Tensor          # [B, T_in] int64
    input_lengths: torch.Tensor   # [B] int64
    speaker_ids: torch.Tensor     # [B] int64
    mel_targets: torch.Tensor     # [B, T_out, M] float32
    linear_targets: torch.Tensor  # [B, T_out, F] float32


class WaveNetDeviceBatch(NamedTuple):
    """A ``data.wavenet_feeder.WaveNetBatch`` as tensors on the training
    device."""
    audio: torch.Tensor                  # [B, window] float32
    speaker_ids: torch.Tensor            # [B] int64
    mel: torch.Tensor                    # [B, F, M] or [B, window, M] float32
    mel_phase: Optional[torch.Tensor]    # [B] int64, None per-sample


def _move(x: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on CUDA through pinned memory without
    blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def batch_to_device(batch, device) -> TacotronBatch:
    """The Tacotron fields of a ``data.feeder.Batch`` (numpy) on
    ``device``. A :class:`TacotronBatch` is already there and passes."""
    if isinstance(batch, TacotronBatch):
        return batch
    device = torch.device(device)

    def move(x, dtype):
        return _move(x, dtype, device)

    return TacotronBatch(move(batch.inputs, torch.int64),
                         move(batch.input_lengths, torch.int64),
                         move(batch.speaker_ids, torch.int64),
                         move(batch.mel_targets, torch.float32),
                         move(batch.linear_targets, torch.float32))


def create_state(model, optimizer, seed: int, ema: bool = False,
                 device="cpu") -> TrainState:
    """Step 0: the model's ``init(seed)`` on ``device`` (a model without
    batch norm, WaveNet, gets an empty ``bn_state``), a fresh optimizer
    state and, with ``ema``, an average that starts at (a copy of) the
    params."""
    init = model.init(seed)
    params, bn_state = init if isinstance(init, tuple) else (init, {})
    params = tree_map(lambda t: t.to(device), params)
    bn_state = tree_map(lambda t: t.to(device), bn_state)
    ema_params = tree_map(torch.clone, params) if ema else None
    return TrainState(0, params, bn_state, optimizer.init(params), ema_params)


def ema_update(ema, new_params, decay: float):
    if not decay or ema is None:
        return ema
    return tree_map(lambda e, p: e * decay + (1.0 - decay) * p, ema, new_params)


def leaf_norms(tree) -> torch.Tensor:
    """Per-leaf gradient norms, in ``tree_leaves`` order."""
    return torch.stack([torch.sqrt(torch.sum(torch.square(x)))
                        for x in tree_leaves(tree)])


def wavenet_batch_to_device(batch, device) -> WaveNetDeviceBatch:
    """A ``data.wavenet_feeder.WaveNetBatch`` (numpy) on ``device``. A
    :class:`WaveNetDeviceBatch` is already there and passes."""
    if isinstance(batch, WaveNetDeviceBatch):
        return batch
    device = torch.device(device)
    return WaveNetDeviceBatch(
        _move(batch.audio, torch.float32, device),
        _move(batch.speaker_ids, torch.int64, device),
        _move(batch.mel, torch.float32, device),
        None if batch.mel_phase is None
        else _move(batch.mel_phase, torch.int64, device))


def _trainable(params):
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def _grads(loss: torch.Tensor, params):
    """d loss / d params as a tree like ``params`` (zeros for a leaf the
    loss does not reach)."""
    leaves = tree_leaves(params)
    grads = dict(zip(map(id, leaves),
                     torch.autograd.grad(loss, leaves, allow_unused=True)))
    return tree_map(lambda p: (torch.zeros_like(p) if grads[id(p)] is None
                               else grads[id(p)]), params)


def tacotron_grads(model, state: TrainState, batch: TacotronBatch,
                   generator: Optional[torch.Generator],
                   deferred_dw: Optional[bool] = None, dp=None, tp=None):
    """(grads, metrics, new_bn_state) of the training loss at
    ``state.params``. ``deferred_dw`` (default: on when the model has
    ``deferred_zero_inputs``) defers the loops' weight gradients
    (``ops/deferred.py``); False takes all of them from autograd.

    With ``dp`` (a ``parallel.mesh.DataParallel``) ``batch`` is this
    rank's rows of the global batch, and the results are the global
    batch's: batch norm, the guided-attention denominator and the random
    draws are global inside the forward (``parallel/collectives.py``), and
    the gradients (after the deferred merge) and the metrics are averaged
    over the ranks.

    With ``tp`` (a ``parallel.mesh.TensorParallel``) ``state`` holds this
    model rank's slices of the weights ``model.tp_rules`` shard, the
    forward runs inside ``collectives.tensor_parallel``, and the
    gradients are this rank's slices of the whole gradient (those of the
    replicated weights whole, and equal on every model rank); ``dp`` is
    then the data axis, and the averages run over it alone."""
    if deferred_dw is None:
        deferred_dw = hasattr(model, "deferred_zero_inputs")
    taps = None
    params = _trainable(state.params)
    with collectives.data_parallel(dp), collectives.tensor_parallel(tp):
        if deferred_dw:
            n, t_out = batch.mel_targets.shape[:2]
            taps = model.deferred_zero_inputs(
                n, t_out // model.cfg.outputs_per_step,
                t_in=batch.inputs.shape[1], t_out=t_out)
        outputs, new_bn = model.forward_train(
            params, state.bn_state, batch.inputs, batch.input_lengths,
            batch.speaker_ids, batch.mel_targets, is_training=True,
            generator=generator, deferred=taps)
        loss, metrics = model.loss(outputs, batch.mel_targets,
                                   batch.linear_targets)
        grads = _grads(loss, params)
    with torch.no_grad():
        if taps is not None:
            grads = model.deferred_merge_grads(grads, taps)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if dp is not None:
            grads = collectives.average_grads(grads, dp)
            metrics = collectives.average_metrics(metrics, dp)
    return grads, metrics, new_bn


def grad_norms(grads, tp=None, rules=()):
    """(``grad_norm``, per-leaf ``grad_norms``) of a gradient tree; with
    ``tp``, of the whole tree that ``grads`` holds this model rank's
    slices of (the leaves ``rules`` shard), the same on every rank."""
    if tp is None:
        return global_norm(grads), leaf_norms(grads)
    sq = collectives.leaf_squares(tree_leaves(grads),
                                  sharded_leaves(grads, rules), tp)
    return torch.sqrt(sq.sum()), torch.sqrt(sq)


def build_tacotron_train_step(model, optimizer, schedule=None,
                              ema_decay: float = 0.0,
                              deferred_dw: Optional[bool] = None, dp=None,
                              tp=None):
    """``step_fn(state, batch, generator) -> (state, metrics)`` for
    Tacotron-1/2 on a :class:`TacotronBatch`. Dropout and scheduled
    sampling draw from ``generator`` (on the batch's device). The metrics
    stay on the device: the loss terms, ``grad_norm`` (before the clip),
    ``grad_norms`` (per leaf) and ``learning_rate`` (a float).
    ``deferred_dw`` as in :func:`tacotron_grads`: on by default, as the
    JAX package's step. With ``dp`` (the counterpart of the JAX step's
    ``mesh``) it is the data-parallel step: ``batch`` holds this rank's
    rows, every rank passes a generator of the same seed, and every rank
    leaves with the state and metrics of the plain step on the global
    batch (:func:`tacotron_grads`). With ``tp`` as well it is the
    tensor-parallel step of a state from ``parallel.tensor.
    shard_train_state(state, tp, model.tp_rules)``: the clip and the
    norms read the whole gradient's norm, so every rank takes one
    branch, and the state (params, Adam's moments and the EMA) stays
    sliced."""

    def step_fn(state: TrainState, batch: TacotronBatch,
                generator: Optional[torch.Generator]):
        grads, metrics, new_bn = tacotron_grads(model, state, batch, generator,
                                                deferred_dw, dp, tp)
        with torch.no_grad():
            norm, norms = grad_norms(grads, tp, model.tp_rules)
            updates, new_opt = optimizer.update(grads, state.opt_state, norm)
            new_params = apply_updates(state.params, updates)
            metrics["grad_norm"] = norm
            metrics["grad_norms"] = norms
            if schedule is not None:
                metrics["learning_rate"] = float(schedule(state.step))
            new_state = TrainState(
                state.step + 1, new_params, new_bn, new_opt,
                ema_update(state.ema_params, new_params, ema_decay))
        return new_state, metrics

    return step_fn


def wavenet_grads(net, params, batch: WaveNetDeviceBatch, cfg,
                  use_gc: bool = False, use_lc: bool = False,
                  l2_strength: Optional[float] = None, dp=None):
    """(grads, metrics) of the WaveNet loss at ``params``: the conditioning
    upsampled on the batch's device (``ops/upsample.py`` ``batch_lc``),
    the speakers' rows of the gc table, the float32 cross-entropy plus the
    L2 term. With ``dp`` the gradients and metrics are averaged over the
    ranks (every window has one shape, so the mean of the ranks'
    cross-entropies is the global one)."""
    from nspeech_tpu_torch.ops.upsample import batch_lc

    params = _trainable(params)
    logits, targets = net.forward_train(
        params, batch.audio, gc_ids=batch.speaker_ids if use_gc else None,
        lc=batch_lc(batch, cfg) if use_lc else None)
    loss, metrics = net.loss(logits, targets, params=params,
                             l2_strength=l2_strength)
    grads = _grads(loss, params)
    with torch.no_grad():
        metrics = {k: v.detach() for k, v in metrics.items()}
        if dp is not None:
            grads = collectives.average_grads(grads, dp)
            metrics = collectives.average_metrics(metrics, dp)
    return grads, metrics


def build_wavenet_train_step(net, optimizer, cfg, schedule=None,
                             use_gc: bool = False, use_lc: bool = False,
                             l2_strength: Optional[float] = None,
                             ema_decay: float = 0.0, dp=None):
    """``step_fn(state, batch, generator) -> (state, metrics)`` for WaveNet
    on a :class:`WaveNetDeviceBatch`. The step is deterministic: it draws
    nothing from ``generator``. Metrics as the Tacotron step's: ``loss``
    (the cross-entropy; with L2 also ``l2_loss`` and ``total_loss``),
    ``grad_norm``, ``grad_norms``, ``learning_rate``. With ``dp`` it is
    the data-parallel step over this rank's windows
    (:func:`wavenet_grads`)."""

    def step_fn(state: TrainState, batch: WaveNetDeviceBatch, generator=None):
        del generator
        grads, metrics = wavenet_grads(net, state.params, batch, cfg, use_gc,
                                       use_lc, l2_strength, dp)
        with torch.no_grad():
            updates, new_opt = optimizer.update(grads, state.opt_state)
            new_params = apply_updates(state.params, updates)
            metrics["grad_norm"] = global_norm(grads)
            metrics["grad_norms"] = leaf_norms(grads)
            if schedule is not None:
                metrics["learning_rate"] = float(schedule(state.step))
            new_state = TrainState(
                state.step + 1, new_params, state.bn_state, new_opt,
                ema_update(state.ema_params, new_params, ema_decay))
        return new_state, metrics

    return step_fn


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of one train step, seeded from (seed, step), so a
    resumed run draws what an uninterrupted one would."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return gen

