"""Weight bridge: the JAX package's parameter trees -> the port's tensors.

The caller hands in the JAX package's params (and batch-norm state) as
nested dicts/lists of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``). The port keeps the same
tree, names, shapes and layouts, so the bridge walks the tree against a
template built by the port's own ``init`` for the same config: every
leaf must match a template leaf of the same shape, and a leaf the
template does not have, or a template leaf the tree lacks, raises.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch


def _bridge(template: Any, tree: Any, path: str, device) -> Any:
    if isinstance(template, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{path or '<root>'}: expected a dict, got "
                             f"{type(tree).__name__}")
        extra = sorted(set(tree) - set(template))
        if extra:
            raise ValueError(f"{path or '<root>'}: leaves not consumed by the "
                             f"port: {extra}")
        missing = sorted(set(template) - set(tree))
        if missing:
            raise ValueError(f"{path or '<root>'}: missing {missing}")
        return {k: _bridge(template[k], tree[k], f"{path}/{k}", device)
                for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"{path}: expected a sequence of {len(template)}")
        return [_bridge(t, v, f"{path}[{i}]", device)
                for i, (t, v) in enumerate(zip(template, tree))]
    arr = np.asarray(tree, dtype=np.float32)
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{path}: shape {arr.shape} != {tuple(template.shape)}")
    return torch.from_numpy(arr.copy()).to(device)


def wavenet_params(net, params, device="cpu"):
    """JAX ``WaveNet.init`` params -> the port's params on ``device``."""
    return _bridge(net.init(0), params, "", device)


def tacotron_variables(model, params, state, device="cpu") -> Tuple[Any, Any]:
    """JAX ``Tacotron1.init`` or ``Tacotron2.init`` (params, bn_state) ->
    the port's, on ``device``, for the port's model of the same config."""
    t_params, t_state = model.init(0)
    return (_bridge(t_params, params, "", device),
            _bridge(t_state, state, "", device))


tacotron2_variables = tacotron_variables
