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

On a CUDA batch (and neither ``dp`` nor ``tp``) the Tacotron step runs
as one CUDA graph per padded shape, as the JAX package compiles its step
once per padded shape, and donates its state as that step does
(``donate_argnums=(0,)``): see :func:`build_tacotron_train_step`. The
WaveNet step does the same on a CUDA batch without ``dp``; its windows
have one shape, so one graph serves a run
(:func:`build_wavenet_train_step`). The eager steps pay the host's
dispatch of some 50,000 (Tacotron-2) and 11,000 (the vocoder) launches a
step at the published widths; a replay pays one launch of the whole
graph.

While a profile runs (``utils/profiling.py``) the Tacotron step records
its phases as spans: ``train.to_device`` (the batch's pinned copies),
``train.forward`` (the forward and the loss), ``train.backward``
(autograd), ``train.merge`` (the deferred weight gradients and the
data-parallel average) and ``train.update`` (the norms, the clip and
Adam, the EMA). The WaveNet step records the same phases but
``train.merge``. They time the host's dispatch of each phase; the card
runs behind it. A step that replays a CUDA graph records
``train.replay`` in their place (attributes ``captured``, true on the
step that captured its graph, and ``shape``, the shapes of the batch's
fields, None for a field that is None); the step that captures records
the phase spans of its capture under it, and a shape's first step, which
runs eagerly, records them as the eager step does.

Both models' steps, and the time-sharded vocoder step of
``parallel/timeshard.py``, are one model-specific gradient function over
one step core (:func:`build_train_step`): the norms, the clip and Adam,
the EMA, and the CUDA graphs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from nspeech_tpu_torch.parallel import collectives
from nspeech_tpu_torch.parallel.tensor import sharded_leaves
from nspeech_tpu_torch.train.optim import apply_updates, global_norm
from nspeech_tpu_torch.utils import profiling
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


def _to_device(batch, kind, device):
    """The ``kind`` fields of a feeder batch (numpy) on ``device``: integer
    fields as int64, the others as float32, on CUDA through pinned memory
    without blocking the host; a field that is None stays None. A batch of
    ``kind`` is already there and passes."""
    if isinstance(batch, kind):
        return batch
    device = torch.device(device)

    def move(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        t = t.to(torch.float32 if t.is_floating_point() else torch.int64)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    with profiling.span("train.to_device"):
        return kind(*(None if x is None else move(x)
                      for x in (getattr(batch, f) for f in kind._fields)))


def batch_to_device(batch, device) -> TacotronBatch:
    """The Tacotron fields of a ``data.feeder.Batch`` on ``device``."""
    return _to_device(batch, TacotronBatch, device)


def wavenet_batch_to_device(batch, device) -> WaveNetDeviceBatch:
    """A ``data.wavenet_feeder.WaveNetBatch`` on ``device``."""
    return _to_device(batch, WaveNetDeviceBatch, device)


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


def trainable(params):
    """A copy of ``params`` whose leaves autograd differentiates."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def autograd_grads(loss: torch.Tensor, params):
    """d loss / d params (a :func:`trainable` tree) as a tree like
    ``params`` (zeros for a leaf the loss does not reach)."""
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
    params = trainable(state.params)
    with collectives.data_parallel(dp), collectives.tensor_parallel(tp):
        with profiling.span("train.forward"):
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
        with profiling.span("train.backward"):
            grads = autograd_grads(loss, params)
    with torch.no_grad(), profiling.span("train.merge"):
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


def shape_key(batch, generator) -> tuple:
    """The key of the CUDA graph that a step on ``batch`` replays: the
    shape of each of the batch's fields (None for a field that is None)
    and whether there is a generator to draw from. Everything else that
    the captured work depends on is fixed when the step is built."""
    return (tuple(None if x is None else tuple(x.shape) for x in batch),
            generator is not None)


def _donated(state: TrainState) -> tuple:
    """The trees a graphed step updates in place: params, batch-norm
    state, Adam's moments and the EMA (None without one)."""
    return (state.params, state.bn_state, state.opt_state["mu"],
            state.opt_state["nu"], state.ema_params)


def _leaves(trees) -> list:
    return [x for tree in trees if tree is not None for x in tree_leaves(tree)]


class _Graph(NamedTuple):
    graph: Any                        # torch.cuda.CUDAGraph
    inputs: NamedTuple                # the static batch it reads
    metrics: Dict[str, torch.Tensor]  # its outputs, in the graphs' pool


class CudaGraphSteps:
    """A train step as CUDA graphs, one per :func:`shape_key`, over one set
    of static state buffers on the card. The batch is any NamedTuple of
    tensors on the card; a field that is None
    (``WaveNetDeviceBatch.mel_phase`` per sample) stays None.

    A key's first call runs the step eagerly, on the stream that captures
    run on (the first such call sets up cuBLAS's workspaces and autograd's
    device thread there, outside a capture), and writes the new state
    into the static buffers. Its second call captures the step, and that
    call and every later one replay the graph. A capture costs the host
    about twice an eager step's dispatch, and its instantiation more
    again, so a shape seen once is not captured. Each
    call copies the state into the static buffers unless it holds them; a
    replay copies the batch into the graph's static batch, Adam's scalars
    (``Adam.scalars``) into its 0-dim device tensors, and the caller's
    generator state into the generator the graphs draw from (its draws
    are the eager step's; the caller's generator then stands where the
    eager step leaves it). The graph writes the new state into the static
    buffers after their last read, and the metrics are copied out of the
    graphs' one memory pool, which every graph reuses. A step that reads a
    device value on the host cannot be captured: the WaveNet step checks
    its gc ids before the call."""

    def __init__(self, step: Callable, optimizer):
        self.step, self.optimizer = step, optimizer
        self.graphs: Dict[tuple, _Graph] = {}
        self.seen: set = set()            # keys whose first call ran eagerly
        self.static = None                # _donated() trees on the card
        self.scalars = None               # Adam's (lr, c1, c2) on the card
        self.stream = self.pool = self.generator = None

    def __call__(self, state: TrainState, batch: NamedTuple,
                 generator: Optional[torch.Generator]):
        if self.static is None:
            self._start(state)
        self._take(state)
        key = shape_key(batch, generator)
        if key not in self.graphs and key not in self.seen:
            self.seen.add(key)
            return self._eager(state, batch, generator)
        count = state.opt_state["count"]
        captured = key not in self.graphs
        with profiling.span("train.replay", captured=captured, shape=key[0]):
            if captured:
                self.graphs[key] = self._capture(state, generator, batch)
            g = self.graphs[key]
            for dst, src in zip(g.inputs, batch):
                if dst is not None:
                    dst.copy_(src)
            for t, v in zip(self.scalars, self.optimizer.scalars(count)):
                t.fill_(v)
            if generator is not None:
                self.generator.set_state(generator.get_state())
            g.graph.replay()
            if generator is not None:
                generator.set_state(self.generator.get_state())
            metrics = {k: v.clone() for k, v in g.metrics.items()}
        return self._state(state.step + 1, count + 1), metrics

    def _state(self, step: int, count: int) -> TrainState:
        params, bn_state, mu, nu, ema = self.static
        return TrainState(step, params, bn_state,
                          {"count": count, "mu": mu, "nu": nu}, ema)

    def _start(self, state: TrainState) -> None:
        """The static buffers (shaped as ``state``'s trees), Adam's
        scalars, the capture stream, the graphs' pool and their
        generator."""
        self.static = tuple(None if tree is None else tree_map(torch.empty_like, tree)
                            for tree in _donated(state))
        moment = tree_leaves(self.static[2])[0]
        self.scalars = self.optimizer.scalar_tensors(0, moment)
        self.stream = torch.cuda.Stream(moment.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.generator = torch.Generator(moment.device)

    def _eager(self, state, batch, generator):
        main = torch.cuda.current_stream(batch[0].device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            new, metrics = self.step(
                self._state(state.step, state.opt_state["count"]), batch, generator)
            torch._foreach_copy_(_leaves(self.static), _leaves(_donated(new)))
        # the step's tensors free into the capture stream's blocks, which
        # the next call on that stream reuses only after waiting for main
        main.wait_stream(self.stream)
        return self._state(new.step, new.opt_state["count"]), metrics

    def _take(self, state: TrainState) -> None:
        """Donation: a state that does not hold the static buffers is
        copied into them."""
        static, leaves = _leaves(self.static), _leaves(_donated(state))
        if len(leaves) == len(static) and all(a is b for a, b in zip(static, leaves)):
            return
        if [x.shape for x in leaves] != [x.shape for x in static]:
            raise ValueError("the state does not match the graphed step's buffers")
        torch._foreach_copy_(static, leaves)

    def _capture(self, state, generator, batch) -> _Graph:
        device = batch[0].device
        # a capture allocates from the graphs' pool and cannot release the
        # cache's free blocks to the card while it runs: where the cache
        # holds more than the card has free (another model trained in this
        # process), it is emptied first
        if (torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
                > torch.cuda.mem_get_info(device)[0]):
            torch.cuda.empty_cache()
        inputs = type(batch)(*(None if x is None else torch.empty_like(x)
                               for x in batch))
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(self.generator)
        # not torch.cuda.graph: it also empties the card's and the pinned
        # host memory's caches, so each capture's next batches allocate anew
        self.stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self.stream):
            graph.capture_begin(self.pool)
            try:
                new, metrics = self.step(
                    self._state(state.step, state.opt_state["count"]), inputs,
                    None if generator is None else self.generator, self.scalars)
                torch._foreach_copy_(_leaves(self.static), _leaves(_donated(new)))
            finally:
                graph.capture_end()
        return _Graph(graph, inputs, metrics)


def build_train_step(grads_fn: Callable, optimizer, schedule=None,
                     ema_decay: float = 0.0, tp=None, rules=(), graphed: bool = True):
    """The step core: ``step_fn(state, batch, generator=None) -> (state,
    metrics)`` from a model's gradient function ``grads_fn(state, batch,
    generator) -> (grads, metrics, new_bn_state)``.

    The update (span ``train.update``) takes the global norm and the
    per-leaf norms once (:func:`grad_norms`; with ``tp`` the whole
    gradient's, of the leaves ``rules`` shard), clips and steps Adam with
    that norm, applies the update, moves the EMA with ``ema_decay``, and
    adds the metrics ``grad_norm`` (before the clip) and ``grad_norms``;
    ``learning_rate`` (a float, ``schedule(state.step)``) is added after
    the step, eager or graphed.

    With ``graphed`` a step on a CUDA batch runs as CUDA graphs
    (:class:`CudaGraphSteps`, ``step_fn.graphs``, whose ``step`` is the
    eager step); a step on a batch off CUDA runs eagerly. A data- or
    tensor-parallel step is built with ``graphed`` false: its collectives
    stay outside graphs."""

    def eager(state: TrainState, batch: NamedTuple,
              generator: Optional[torch.Generator], scalars=None):
        grads, metrics, new_bn = grads_fn(state, batch, generator)
        with torch.no_grad(), profiling.span("train.update"):
            norm, norms = grad_norms(grads, tp, rules)
            updates, new_opt = optimizer.update(grads, state.opt_state, norm,
                                                scalars)
            new_params = apply_updates(state.params, updates)
            metrics["grad_norm"] = norm
            metrics["grad_norms"] = norms
            new_state = TrainState(
                state.step + 1, new_params, new_bn, new_opt,
                ema_update(state.ema_params, new_params, ema_decay))
        return new_state, metrics

    graphs = CudaGraphSteps(eager, optimizer)

    def step_fn(state: TrainState, batch: NamedTuple,
                generator: Optional[torch.Generator] = None):
        if graphed and batch[0].device.type == "cuda":
            new_state, metrics = graphs(state, batch, generator)
        else:
            new_state, metrics = graphs.step(state, batch, generator)
        if schedule is not None:
            metrics["learning_rate"] = float(schedule(state.step))
        return new_state, metrics

    step_fn.graphs = graphs
    return step_fn


def build_tacotron_train_step(model, optimizer, schedule=None,
                              ema_decay: float = 0.0,
                              deferred_dw: Optional[bool] = None, dp=None,
                              tp=None):
    """``step_fn(state, batch, generator) -> (state, metrics)`` for
    Tacotron-1/2 on a :class:`TacotronBatch`: :func:`tacotron_grads` over
    the step core (:func:`build_train_step`). Dropout and scheduled
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
    sliced.

    The step reads its configuration once, when it is built: the model's
    config (the compute dtype, the scheduled-sampling ratio) and these
    arguments. On a CUDA batch without ``dp`` and ``tp`` the step runs as
    CUDA graphs, one per padded shape (:func:`shape_key`,
    :class:`CudaGraphSteps`, ``step_fn.graphs``; a shape's first step
    runs eagerly, its second captures), and DONATES its state,
    as the JAX package's jitted step does (``donate_argnums=(0,)``): the
    params, batch-norm state, Adam's moments and the EMA are updated in
    place in static buffers on the card, the returned state holds them,
    and a state passed in that holds them is consumed (the next step
    overwrites them). Its kernels and their order are the eager step's,
    and so are its random draws."""
    if deferred_dw is None:
        deferred_dw = hasattr(model, "deferred_zero_inputs")

    def grads_fn(state, batch, generator):
        return tacotron_grads(model, state, batch, generator, deferred_dw, dp, tp)

    return build_train_step(grads_fn, optimizer, schedule, ema_decay, tp,
                            model.tp_rules, graphed=dp is None and tp is None)


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

    params = trainable(params)
    with profiling.span("train.forward"):
        logits, targets = net.forward_train(
            params, batch.audio, gc_ids=batch.speaker_ids if use_gc else None,
            lc=batch_lc(batch, cfg) if use_lc else None)
        loss, metrics = net.loss(logits, targets, params=params,
                                 l2_strength=l2_strength)
    with profiling.span("train.backward"):
        grads = autograd_grads(loss, params)
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
    """``step_fn(state, batch, generator=None) -> (state, metrics)`` for
    WaveNet on a :class:`WaveNetDeviceBatch`: :func:`wavenet_grads` over
    the step core (:func:`build_train_step`). The step is deterministic:
    it draws nothing from ``generator``. Metrics as the Tacotron step's:
    ``loss`` (the cross-entropy; with L2 also ``l2_loss`` and
    ``total_loss``), ``grad_norm``, ``grad_norms``, ``learning_rate``.
    With ``dp`` it is the data-parallel step over this rank's windows
    (:func:`wavenet_grads`).

    The step reads its configuration once, when it is built: ``cfg``, the
    net's config (the compute dtype) and these arguments. On a CUDA batch
    without ``dp`` it runs as CUDA graphs and DONATES its state as the
    Tacotron step does (:func:`build_tacotron_train_step`); its windows
    have one shape, so one graph serves a run. With ``use_gc`` the
    speaker ids are checked on the host before each step, so an id
    outside the table raises before a graph runs, as it does in the
    eager step."""

    def grads_fn(state, batch, generator):
        grads, metrics = wavenet_grads(net, state.params, batch, cfg, use_gc,
                                       use_lc, l2_strength, dp)
        return grads, metrics, state.bn_state

    step = build_train_step(grads_fn, optimizer, schedule, ema_decay, graphed=dp is None)

    def step_fn(state: TrainState, batch: WaveNetDeviceBatch, generator=None):
        if use_gc and net.gc_channels:
            # on the host, as a graph cannot read them
            net.check_gc_ids(state.params, batch.speaker_ids)
        return step(state, batch)        # it draws nothing: its graph registers no generator

    step_fn.graphs = step.graphs
    return step_fn


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of one train step, seeded from (seed, step), so a
    resumed run draws what an uninterrupted one would."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return gen

