"""The port's checkpoints: run metadata, training states and serving
archives.

Layout of a checkpoint directory::

    <dir>/config.json            run metadata (train/metadata.py)
    <dir>/serving/<step>.npz     the serving parameters of training step <step>
    <dir>/train/<step>.pt        the whole training state of step <step>
                                 (:class:`CheckpointManager`)

The archive holds the JAX package's parameter tree (``params/...``) and,
for a Tacotron, its batch-norm state (``bn_state/...``); each key is the
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
from nspeech_tpu_torch.models import Tacotron1, Tacotron2, WaveNet
from nspeech_tpu_torch.train.loop import TrainState
from nspeech_tpu_torch.train.metadata import save_run_metadata
from nspeech_tpu_torch.utils.tree import named_leaves, tree_map

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
                            cfg: Config, params, bn_state=None,
                            speaker_map=None) -> str:
    """Write ``config.json`` (with ``speaker_map`` when given) and
    ``serving/<step>.npz`` (atomically); returns the archive's path.
    ``params``/``bn_state`` are trees of tensors or arrays in the JAX
    package's layout."""
    save_run_metadata(ckpt_dir, model_name, cfg, speaker_map=speaker_map)
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
    """``(params, bn_state)`` of ``model`` (a ``WaveNet`` or a Tacotron;
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
    if isinstance(model, (Tacotron1, Tacotron2)):
        return convert.tacotron_variables(model, params,
                                          _unflatten(flat, "bn_state"), device)
    raise TypeError(f"no serving checkpoint for {type(model).__name__}")


TRAIN_DIR = "train"


def _shapes(tree) -> Dict[str, tuple]:
    return {p: tuple(getattr(t, "shape", ())) for p, t in named_leaves(tree)}


class CheckpointManager:
    """Training states under ``<directory>/train/<step>.pt`` and, with each,
    the serving archive ``<directory>/serving/<step>.npz`` (the EMA params
    when the state has them) and ``config.json`` with the speaker map."""

    def __init__(self, directory: str, model_name: str, cfg: Config,
                 speaker_map=None, max_to_keep: int = 5,
                 keep_period_hours: float = 2.0):
        self.directory = directory
        self._train = os.path.join(directory, TRAIN_DIR)
        os.makedirs(self._train, exist_ok=True)
        self._model_name, self._cfg = model_name, cfg
        self._speaker_map = speaker_map
        self.max_to_keep = max_to_keep
        self.keep_period_s = keep_period_hours * 3600.0

    def _path(self, step: int) -> str:
        return os.path.join(self._train, f"{int(step)}.pt")

    def all_steps(self) -> list:
        return sorted(int(f[:-3]) for f in os.listdir(self._train)
                      if f.endswith(".pt") and f[:-3].isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Write the state of ``step`` (atomically), its serving archive,
        then apply the retention policy."""
        tree = {"step": int(step), "params": state.params,
                "bn_state": state.bn_state, "opt_state": state.opt_state}
        if state.ema_params is not None:
            tree["ema_params"] = state.ema_params
        tree = tree_map(lambda t: t.detach().cpu()
                        if isinstance(t, torch.Tensor) else t, tree)
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        serving = tree.get("ema_params", tree["params"])
        save_serving_checkpoint(self.directory, step, self._model_name,
                                self._cfg, serving, tree["bn_state"],
                                speaker_map=self._speaker_map)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        keep = set(steps[-self.max_to_keep:])
        last_kept = None
        for s in steps:   # Orbax's EveryNSeconds: the oldest, then every period
            t = os.stat(self._path(s)).st_mtime
            if last_kept is None or t - last_kept >= self.keep_period_s:
                keep.add(s)
                last_kept = t
        for s in steps:
            if s not in keep:
                os.remove(self._path(s))
                npz = os.path.join(self.directory, SERVING_DIR, f"{s}.npz")
                if os.path.exists(npz):
                    os.remove(npz)

    def restore(self, state_like, step: Optional[int] = None, device="cpu"):
        """The state of ``step`` (the latest by default) on ``device``, in
        the structure of ``state_like`` (a ``TrainState``). A checkpoint
        without an EMA restored where one is kept seeds the average at the
        restored params; one with an EMA restored where none is kept drops
        it. Any other difference in the trees raises."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no training checkpoint under {self._train}")
        path = self._path(step)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} (steps: {self.all_steps()})")
        tree = torch.load(path, map_location=device, weights_only=True)
        if state_like.ema_params is None:
            tree.pop("ema_params", None)
        elif "ema_params" not in tree:
            tree["ema_params"] = tree_map(torch.clone, tree["params"])
        for name in ("params", "bn_state", "opt_state", "ema_params"):
            want = getattr(state_like, name)
            if want is not None and _shapes(tree[name]) != _shapes(want):
                raise ValueError(f"{path}: {name} does not match the model "
                                 "(another architecture or hparams?)")
        return TrainState(tree["step"], tree["params"], tree["bn_state"],
                          tree["opt_state"], tree.get("ema_params"))

