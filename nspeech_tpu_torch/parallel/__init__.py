"""Data and tensor parallelism across cards (and CPU devices): port of
``nspeech_tpu/parallel``. ``mesh`` holds the single-process mesh of
serving and the process groups of training; ``collectives`` the
all-reduces of a data-parallel step and the model-axis operators of a
tensor-parallel one; ``tensor`` Tacotron-2's sharding rules and the
placement of a train state on the model axis; ``timeshard`` and
``lengthshard`` the library forms sharded along time.

The names load on first use: ``ops/layers.py`` reads ``collectives``,
and ``mesh`` and ``lengthshard`` read ``ops/layers.py``."""

import importlib

_NAMES = {
    "make_length_sharded_conv_stack": "lengthshard",
    "make_length_sharded_encoder_convs": "lengthshard",
    "make_length_sharded_postnet": "lengthshard",
    "DATA_AXIS": "mesh", "MODEL_AXIS": "mesh", "DataParallel": "mesh",
    "Mesh": "mesh", "batch_sharding": "mesh", "init_distributed": "mesh",
    "initialize_multihost": "mesh", "make_mesh": "mesh", "replicate": "mesh",
    "replicated": "mesh", "shard_batch": "mesh", "TensorParallel": "mesh",
    "TACO2_TP_RULES": "tensor", "gather_params": "tensor",
    "gather_train_state": "tensor", "merge_params": "tensor",
    "shard_params": "tensor", "shard_train_state": "tensor",
    "spec_for_path": "tensor",
    "build_time_sharded_wavenet_step": "timeshard",
    "make_time_sharded_logits": "timeshard",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"), name)
