"""The port's serving checkpoint: run metadata plus one numpy archive.

Layout of a checkpoint directory::

    <dir>/config.json            run metadata (train/metadata.py)
    <dir>/serving/<step>.npz     the serving parameters of training step <step>

The archive holds the JAX package's parameter tree (``params/...``) and,
for Tacotron-2, its batch-norm state (``bn_state/...``); each key is the
``/``-joined path of a leaf (list items by index), each value a float32
array. The serving parameters are the EMA average when the run kept one,
as the JAX package's ``load_serving_params`` chooses. The tree is the same
in both packages, so either can write the file: the port with
:func:`save_serving_checkpoint`, a JAX run with
``scripts/export_torch_checkpoint.py`` (the port reads no Orbax
checkpoint: those are OCDBT with zstd-compressed chunks).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import Config
from nspeech_tpu_torch.models import Tacotron2, WaveNet
from nspeech_tpu_torch.train.metadata import save_run_metadata

SERVING_DIR = "serving"


def _flatten(tree: Any, path: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{path}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{path}/{i}", out)
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[path] = np.asarray(tree, np.float32)


def _unflatten(flat: Dict[str, np.ndarray], prefix: str) -> Any:
    """Keys ``<prefix>/a/0/b`` -> nested dicts, with a dict whose keys are
    exactly 0..n-1 turned into a list."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = root
        *parents, leaf = key[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"{key}: a leaf and a subtree share a path")
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            if sorted(int(k) for k in node) != list(range(len(node))):
                raise ValueError(f"{prefix}: list items {sorted(node)} are "
                                 "not 0..n-1")
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_serving_checkpoint(ckpt_dir: str, step: int, model_name: str,
                            cfg: Config, params, bn_state=None) -> str:
    """Write ``config.json`` and ``serving/<step>.npz`` (atomically);
    returns the archive's path. ``params``/``bn_state`` are trees of
    tensors or arrays in the JAX package's layout."""
    save_run_metadata(ckpt_dir, model_name, cfg)
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params", flat)
    if bn_state is not None:
        _flatten(bn_state, "bn_state", flat)
    serving = os.path.join(ckpt_dir, SERVING_DIR)
    os.makedirs(serving, exist_ok=True)
    path = os.path.join(serving, f"{int(step)}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    return path


def _serving_steps(ckpt_dir: str) -> list:
    """The steps with a serving archive, in increasing order."""
    serving = os.path.join(ckpt_dir, SERVING_DIR)
    if not os.path.isdir(serving):
        return []
    return sorted(int(f[:-4]) for f in os.listdir(serving)
                  if f.endswith(".npz") and f[:-4].isdigit())


def load_serving_params(ckpt_dir: str, model, step: Optional[int] = None,
                        device="cpu") -> Tuple[Any, Optional[Any]]:
    """``(params, bn_state)`` of ``model`` (a ``WaveNet`` or ``Tacotron2``;
    ``bn_state`` None for WaveNet) from ``serving/<step>.npz``, the latest
    step by default, on ``device``. Raises on a missing, extra or
    misshapen leaf (checked against the model's own tree)."""
    steps = _serving_steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(
                f"no serving checkpoint under {os.path.join(ckpt_dir, SERVING_DIR)}")
        step = steps[-1]
    path = os.path.join(ckpt_dir, SERVING_DIR, f"{int(step)}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} (steps: {steps})")
    with np.load(path) as archive:
        flat = {k: archive[k] for k in archive.files}
    extra = sorted({k.split("/", 1)[0] for k in flat} - {"params", "bn_state"})
    if extra:
        raise ValueError(f"{path}: unknown trees {extra}")
    params = _unflatten(flat, "params")
    if isinstance(model, WaveNet):
        if any(k.startswith("bn_state/") for k in flat):
            raise ValueError(f"{path}: a WaveNet has no bn_state")
        return convert.wavenet_params(model, params, device), None
    if isinstance(model, Tacotron2):
        return convert.tacotron2_variables(model, params,
                                           _unflatten(flat, "bn_state"), device)
    raise TypeError(f"no serving checkpoint for {type(model).__name__}")
