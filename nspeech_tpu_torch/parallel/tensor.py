"""Tensor parallelism: Tacotron-2's weights sharded over the ``model``
axis. Port of ``nspeech_tpu/parallel/tensor.py``.

The JAX package expresses tensor parallelism through shardings alone: a
rules table maps parameter key-paths to PartitionSpecs, the train state
is placed accordingly, and GSPMD partitions the products and inserts the
collectives. The port keeps the same table (:data:`TACO2_TP_RULES`, the
same regexes over the same key-paths, :func:`spec_for_path`), and gives
each model rank its slice of every leaf the rules shard
(:func:`shard_params`, :func:`shard_train_state`). The products and the
collectives are explicit: inside ``collectives.tensor_parallel(tp)`` the
Tacotron-2 layers that hold a slice run as Megatron's column- and
row-parallel products (``ops/layers.py``, ``models/attention.py``), so
the step computes what the plain step computes.

A spec says which axis of a leaf is split; the port also chooses which
indices of that axis each rank holds. An axis that packs several blocks
holds the rank's slice of each block (:data:`_BLOCKS`): an LSTM kernel's
columns are the gates ``[i | g | f | o]``, so each rank holds its units
of all four gates and runs its cells whole; the linear projection's rows
read the expand BiLSTM's ``[fw | bw]``, so each rank holds the rows of
its forward and its backward units. :func:`gather_params` (and
:func:`merge_params`, its form without a process group) puts the slices
back, bit for bit: the whole value a JAX sharded array has.

Tacotron-1 runs replicated along the model axis: its model code has no
sharded layers, and ``Tacotron1.tp_rules`` is empty (JAX's rules would
match eight of its leaves; JAX trains only Tacotron-2 tensor-parallel).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from nspeech_tpu_torch.utils.tree import keystr, leaves_with_path

MODEL_AXIS = "model"

# A PartitionSpec: per axis of the leaf, the mesh axis it is split over
# or None; () replicated.
Spec = Tuple[Optional[str], ...]

# (key-path regex, spec). First match wins; default replicated.
TACO2_TP_RULES: List[Tuple[str, Spec]] = [
    # decoder + attention LSTMs: column-parallel gates
    (r"\['(lstm[12]|attn_lstm)'\]\['kernel'\]", (None, MODEL_AXIS)),
    (r"\['(lstm[12]|attn_lstm)'\]\['bias'\]", (MODEL_AXIS,)),
    # frame projection: row-parallel (contracts the sharded LSTM output)
    (r"\['frame_proj'\]\['kernel'\]", (MODEL_AXIS, None)),
    # prenet: Megatron-style column then row
    (r"\['decoder_prenet'\]\['layers'\]\[0\]\['kernel'\]",
     (None, MODEL_AXIS)),
    (r"\['decoder_prenet'\]\['layers'\]\[0\]\['bias'\]", (MODEL_AXIS,)),
    (r"\['decoder_prenet'\]\['layers'\]\[1\]\['kernel'\]",
     (MODEL_AXIS, None)),
    # attention energy: the three projections and v over the attention
    # dims, so the energy is a sum of partial dots
    (r"\['attention'\]\['(memory|query|location)_layer'\]\['kernel'\]",
     (None, MODEL_AXIS)),
    (r"\['attention'\]\['v'\]", (MODEL_AXIS,)),
    # encoder/expand BiLSTMs: column-parallel gates
    (r"\['(encoder|expand)'\]\['lstm_[fb]w'\]\['kernel'\]",
     (None, MODEL_AXIS)),
    (r"\['(encoder|expand)'\]\['lstm_[fb]w'\]\['bias'\]", (MODEL_AXIS,)),
    # conv stacks: output channels sharded (BN params follow channels)
    (r"\['(encoder|expand|postnet)'\]\['convs'\]\[\d+\]\['conv'\]"
     r"\['kernel'\]", (None, None, MODEL_AXIS)),
    (r"\['(encoder|expand|postnet)'\]\['convs'\]\[\d+\]\['conv'\]"
     r"\['bias'\]", (MODEL_AXIS,)),
    (r"\['(encoder|expand|postnet)'\]\['convs'\]\[\d+\]\['bn'\]"
     r"\['(scale|offset)'\]", (MODEL_AXIS,)),
    # linear projection: row-parallel (1025 freq bins do not divide)
    (r"\['linear_proj'\]\['kernel'\]", (MODEL_AXIS, None)),
]

# (key-path regex, blocks): a sharded axis packed of equal blocks, of
# which each rank holds its slice of each; any other sharded axis is one
# block.
_BLOCKS = [
    (r"\['(lstm[12]|attn_lstm|lstm_[fb]w)'\]", 4),     # gates [i | g | f | o]
    (r"\['linear_proj'\]\['kernel'\]", 2),             # rows [fw | bw]
]


def spec_for_path(path_str: str, rules=TACO2_TP_RULES) -> Spec:
    for pattern, spec in rules:
        if re.search(pattern, path_str):
            return spec
    return ()


def _placement(path: tuple, width_of, world: int, rules):
    """``(axis, blocks)`` of a leaf the rules shard, else None.
    ``width_of(axis)`` is the whole width of that axis, which must divide
    into ``world`` slices of each block."""
    name = keystr(path)
    spec = spec_for_path(name, rules)
    if MODEL_AXIS not in spec:
        return None
    axis = spec.index(MODEL_AXIS)
    blocks = next((k for pattern, k in _BLOCKS if re.search(pattern, name)), 1)
    width = width_of(axis)
    if width % (blocks * world):
        raise ValueError(
            f"{name}: axis {axis} of width {width} does not divide over "
            f"{world} model ranks" + (f" in {blocks} blocks" if blocks > 1 else ""))
    return axis, blocks


def shard_index(width: int, blocks: int, rank: int, world: int) -> torch.Tensor:
    """The indices of an axis of ``width`` (``blocks`` packed blocks) that
    model rank ``rank`` of ``world`` holds: its contiguous slice of each
    block, in block order."""
    block = width // blocks
    per = block // world
    starts = torch.arange(blocks) * block + rank * per
    return (starts[:, None] + torch.arange(per)).reshape(-1)


def _map(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping its
    structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def shard_params(params, tp, rules=TACO2_TP_RULES):
    """The slices of a whole parameter tree that model rank ``tp.rank``
    of ``tp.world`` holds (the leaves no rule matches, whole). Raises
    ``ValueError`` for a sharded width that ``tp.world`` does not
    divide."""
    def one(path, x):
        place = _placement(path, lambda a: x.shape[a], tp.world, rules)
        if place is None:
            return x
        axis, blocks = place
        idx = shard_index(x.shape[axis], blocks, tp.rank, tp.world)
        return x.index_select(axis, idx.to(x.device))

    return _map(one, params)


def merge_params(shards: list, rules=TACO2_TP_RULES):
    """The whole tree from every model rank's slices (``shards`` in rank
    order): the inverse of :func:`shard_params`."""
    world = len(shards)
    per_rank = [dict(leaves_with_path(s)) for s in shards]

    def one(path, x):
        place = _placement(path, lambda a: x.shape[a] * world, world, rules)
        if place is None:
            return x
        axis, blocks = place
        shape = list(x.shape)
        shape[axis] *= world
        out = x.new_empty(shape)
        for rank, leaves in enumerate(per_rank):
            idx = shard_index(shape[axis], blocks, rank, world).to(x.device)
            out.index_copy_(axis, idx, leaves[path])
        return out

    return _map(one, shards[0])


def gather_params(local, tp, rules=TACO2_TP_RULES):
    """The whole tree on every model rank of ``tp`` from its slices
    ``local``: one all-gather per sharded leaf (every rank in one
    order)."""
    pieces = {}
    for path, x in leaves_with_path(local):
        if _placement(path, lambda a: x.shape[a] * tp.world, tp.world, rules):
            parts = [torch.empty_like(x) for _ in range(tp.world)]
            dist.all_gather(parts, x.contiguous(), group=tp.group)
            pieces[path] = parts
    shards = [_map(lambda path, x, r=r: pieces[path][r] if path in pieces else x,
                   local) for r in range(tp.world)]
    return merge_params(shards, rules)


def sharded_leaves(tree, rules=TACO2_TP_RULES) -> List[bool]:
    """Per leaf, in ``tree_leaves`` order: whether the rules shard it."""
    return [MODEL_AXIS in spec_for_path(keystr(path), rules)
            for path, _ in leaves_with_path(tree)]


def _mirrors(node, params) -> bool:
    """Whether ``node`` has the tree structure of ``params`` (Adam's
    moments)."""
    return ([p for p, _ in leaves_with_path(node)]
            == [p for p, _ in leaves_with_path(params)])


def _place_state(state, place):
    """A ``train.loop.TrainState`` with ``place`` applied to its params,
    to each optimizer-state node that mirrors them and to its EMA; the
    step, the batch-norm state and the other optimizer nodes (the update
    count) are replicated and stay as they are."""
    opt = {k: place(v) if _mirrors(v, state.params) else v
           for k, v in state.opt_state.items()}
    return state._replace(
        params=place(state.params), opt_state=opt,
        ema_params=None if state.ema_params is None else place(state.ema_params))


def shard_train_state(state, tp, rules=TACO2_TP_RULES):
    """This model rank's slices of a whole train state: the params, Adam's
    ``mu`` and ``nu`` and the EMA by the rules (JAX replicates the EMA;
    here it is sliced as the params are, and :func:`gather_train_state`
    gives the whole one back)."""
    return _place_state(state, lambda t: shard_params(t, tp, rules))


def gather_train_state(state, tp, rules=TACO2_TP_RULES):
    """The whole train state on every model rank from the slices of
    :func:`shard_train_state`."""
    return _place_state(state, lambda t: gather_params(t, tp, rules))
