"""Import trained reference (TensorFlow) WaveNet checkpoints.

The reference's WaveNet keeps every weight in an explicit variable tree
(reference: neural_speech/models/wavenet.py:136-253) whose checkpoint
names this module maps onto the ``WaveNet.init`` param tree (the same in
the JAX package and the port).
Both use the same ``[width, in, out]`` conv-filter orientation, so the
import is a rename — no transposes — and a checkpoint trained with the
reference's ``train_wavenet.py`` drops straight into the port's serving
stack. A copy of the JAX package's ``nspeech_tpu/migrate/reference.py``.

Checkpoint-name contract details preserved here:

* Bias variables are named ``Variable``..``Variable_3`` per layer (in
  filter/gate/dense/skip creation order) because the reference passes
  ``name`` into ``tf.Variable``'s *trainable* slot
  (reference: wavenet.py:29-33 ``tf.Variable(initializer(shape), name)``)
  — the dict key ``'slip_bias'`` typo (wavenet.py:232) never reaches the
  checkpoint for the same reason.
* ``gc_channels: 0`` / ``lc_channels: 0`` hparams still create
  zero-sized gc/lc variables (the reference guards with ``is not None``,
  wavenet.py:144/201/211, so ``0`` passes) — stock checkpoints carry
  ``[1, 0, DC]`` weights that are dead in the forward pass. They are
  recognized and skipped.

The port's mapping is held to the JAX package's, tree for tree, in
``tests/test_torch_migrate.py`` (the JAX package's own tests hold it to
the reference's forward pass).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np

from nspeech_tpu_torch.migrate.tfbundle import TFBundleReader

_LAYER_RE = re.compile(r"^wavenet/dilated_stack/layer(\d+)/(.+)$")

# Checkpoint suffix -> our per-layer param key. Biases appear in creation
# order filter/gate/dense/skip (wavenet.py:222-235).
_LAYER_KEYS = {
    "filter": "filter",
    "gate": "gate",
    "dense": "dense",
    "skip": "skip",
    "gc_filter": "gc_filter",
    "gc_gate": "gc_gate",
    "lc_filter": "lc_filter",
    "lc_gate": "lc_gate",
    "Variable": "filter_bias",
    "Variable_1": "gate_bias",
    "Variable_2": "dense_bias",
    "Variable_3": "skip_bias",
}


class ImportError_(ValueError):
    """Checkpoint does not look like a reference WaveNet."""


def _is_optimizer_slot(name: str) -> bool:
    """tf.train.AdamOptimizer slots: '<var>/Adam', '/Adam_1', plus the
    beta power scalars — present in training checkpoints, never needed."""
    return ("/Adam" in name or name.endswith("beta1_power")
            or name.endswith("beta2_power"))


def _tensors(src) -> Dict[str, np.ndarray]:
    if isinstance(src, str):
        src = TFBundleReader(src)
    if isinstance(src, TFBundleReader):
        # Skip optimizer slots BEFORE decoding: they are ~2x the model
        # bytes and the pure-Python reader checksums every byte it reads.
        return {name: src.get_tensor(name) for name in src.variable_names()
                if not _is_optimizer_slot(name)}
    return dict(src)


def import_wavenet(src) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Map a reference WaveNet checkpoint to (params, derived_hparams).

    ``src`` is a checkpoint prefix path, a :class:`TFBundleReader`, or a
    ``{name: ndarray}`` mapping. Returns our ``WaveNet.init``-shaped
    param tree (float32 numpy leaves) plus the hparams that are fully
    determined by the weight shapes. ``dilations_length`` /
    ``dilations_depth`` cannot be recovered from shapes (only their
    product can) — callers must supply them and
    :func:`check_dilations` validates the product.
    """
    tensors = _tensors(src)
    # Dict inputs may still carry optimizer state — drop it here too
    # (reader inputs already skipped the slots before decoding).
    tensors = {name: arr for name, arr in tensors.items()
               if not _is_optimizer_slot(name)}
    if "wavenet/causal_layer/filter" not in tensors:
        raise ImportError_(
            "no 'wavenet/causal_layer/filter' — not a reference WaveNet "
            f"checkpoint (found {len(tensors)} variables)")

    params: Dict[str, Any] = {}
    causal = tensors.pop("wavenet/causal_layer/filter")
    params["causal"] = causal.astype(np.float32)
    scalar_input = causal.shape[1] == 1

    gc_emb = tensors.pop("wavenet/embeddings/gc_embedding", None)
    if gc_emb is not None and 0 not in gc_emb.shape:
        params["gc_embedding"] = gc_emb.astype(np.float32)
    gc_channels = int(gc_emb.shape[1]) if gc_emb is not None else 0
    gc_cardinality = int(gc_emb.shape[0]) if gc_emb is not None else 0

    layers: Dict[int, Dict[str, np.ndarray]] = {}
    lc_channels = 0
    for name in list(tensors):
        m = _LAYER_RE.match(name)
        if not m:
            continue
        idx, suffix = int(m.group(1)), m.group(2)
        key = _LAYER_KEYS.get(suffix)
        if key is None:
            raise ImportError_(f"unrecognized layer variable '{name}'")
        arr = tensors.pop(name)
        if 0 in arr.shape:  # dead zero-channel gc/lc weights (see module doc)
            continue
        if key.startswith("lc_"):
            lc_channels = int(arr.shape[1])
        layers.setdefault(idx, {})[key] = arr.astype(np.float32)

    if not layers:
        raise ImportError_("checkpoint has no dilated-stack layers")
    n_layers = max(layers) + 1
    if sorted(layers) != list(range(n_layers)):
        raise ImportError_(
            f"non-contiguous layer indices: {sorted(layers)}")
    use_biases = "filter_bias" in layers[0]
    for i in range(n_layers):
        lp = layers[i]
        expected = {"filter", "gate", "dense", "skip"}
        if use_biases:
            expected |= {"filter_bias", "gate_bias", "dense_bias",
                         "skip_bias"}
        if gc_channels and "gc_filter" in layers[0]:
            expected |= {"gc_filter", "gc_gate"}
        if lc_channels:
            expected |= {"lc_filter", "lc_gate"}
        missing = expected - set(lp)
        if missing:
            raise ImportError_(f"layer {i} missing {sorted(missing)}")
    params["layers"] = [layers[i] for i in range(n_layers)]

    try:
        post1 = tensors.pop("wavenet/postprocessing/postprocess1")
        post2 = tensors.pop("wavenet/postprocessing/postprocess2")
    except KeyError as e:
        raise ImportError_(f"missing postprocessing weight: {e}") from None
    params["post1"] = post1.astype(np.float32)
    params["post2"] = post2.astype(np.float32)
    if use_biases:
        params["post1_bias"] = tensors.pop(
            "wavenet/postprocessing/Variable").astype(np.float32)
        params["post2_bias"] = tensors.pop(
            "wavenet/postprocessing/Variable_1").astype(np.float32)

    leftovers = [n for n in tensors if n.startswith("wavenet/")]
    if leftovers:
        raise ImportError_(f"unmapped model variables: {sorted(leftovers)}")

    f0 = params["layers"][0]["filter"]
    hparams: Dict[str, Any] = {
        "filter_width": int(f0.shape[0]),
        "residual_channels": int(f0.shape[1]),
        "dilation_channels": int(f0.shape[2]),
        "skip_channels": int(params["post1"].shape[1]),
        "quantization_channels": int(params["post2"].shape[2]),
        "use_biases": use_biases,
        "scalar_input": scalar_input,
        "gc_channels": gc_channels if "gc_embedding" in params else 0,
        "gc_category_cardinality": (gc_cardinality
                                    if "gc_embedding" in params else 0),
        "lc_channels": lc_channels,
        "n_layers": n_layers,
    }
    if scalar_input:
        hparams["initial_filter_width"] = int(causal.shape[0])
    return params, hparams


def check_dilations(n_layers: int, dilations_length: int,
                    dilations_depth: int) -> None:
    if dilations_length * dilations_depth != n_layers:
        raise ImportError_(
            f"dilations_length*dilations_depth = "
            f"{dilations_length}*{dilations_depth} != checkpoint's "
            f"{n_layers} layers — pass the training-time values "
            "(they cannot be recovered from weight shapes)")
