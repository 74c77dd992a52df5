"""The one-shot WaveNet sampler (K1/K2) as a registered operator,
``nspeech::wavenet_sample``, so that a ``torch.export`` program can call
it: the vocoder artifact of ``serving/export.py`` does.

On CUDA tensors the operator launches the kernel through
:data:`wavenet_gen.SAMPLER` (so its launches count there) or raises; on
CPU tensors it runs the plain version, ``WaveNet.generate``. These are
the two routes of :class:`wavenet_gen.CudaWaveNetGenerator.__call__`, so
an artifact gives the live vocoder's codes on either device.

The operator takes both weight layouts, and each device reads its own:
``packed`` is :func:`wavenet_gen.pack_params` (the kernel's layout, with
the speakers' gc rows folded into the biases), and ``weights`` are the
plain parameter leaves, in the order of the tree that ``weights_spec``
(``torch.utils._pytree.treespec_dumps``) describes. The plain version
cannot run from the packed layout bit for bit: packing folds the biases,
the gc projection and each layer's dense product into other sums. The
net's hyperparameters travel as ``net_config``, the JSON of its config.

A program that calls the operator loads only after this module has been
imported (``ExportedVocoder`` imports it), which imports
``models/wavenet.py`` for the plain version.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Optional

import torch
import torch.utils._pytree as pytree

from nspeech_tpu_torch.config import Config
from nspeech_tpu_torch.models.wavenet import WaveNet
from nspeech_tpu_torch.ops.cuda.wavenet_gen import SAMPLER, pack_params

PACKED_KEYS = ("wc", "wfg_chain", "wlc", "bfg", "wdense", "bdense", "head",
               "bskip", "b1", "b2", "dilations")


@functools.lru_cache(maxsize=None)
def _net(net_config: str) -> WaveNet:
    return WaveNet(Config(json.loads(net_config)))


def operator_args(net: WaveNet, params, gc_ids=None) -> Dict[str, object]:
    """The operator's weight arguments for ``net`` and ``params`` (with
    the speakers ``gc_ids`` folded in): ``packed``, ``weights``,
    ``weights_spec``, ``net_config`` and ``gc_ids``."""
    packed = pack_params(net, params, gc_ids)
    weights, spec = pytree.tree_flatten(params)
    return {"packed": [packed[k] for k in PACKED_KEYS], "weights": weights,
            "weights_spec": pytree.treespec_dumps(spec),
            "net_config": json.dumps(net.cfg.values(), sort_keys=True),
            "gc_ids": None if gc_ids is None else [int(i) for i in gc_ids]}


@torch.library.custom_op("nspeech::wavenet_sample", mutates_args=(),
                         device_types="cpu")
def wavenet_sample(packed: List[torch.Tensor], weights: List[torch.Tensor],
                   lc: torch.Tensor, seed: torch.Tensor, temperature: float,
                   net_config: str, weights_spec: str,
                   gc_ids: Optional[List[int]]) -> torch.Tensor:
    """Codes [B, T] int32 for the upsampled conditioning ``lc`` [B, T, M],
    the noise keyed by the integer tensor ``seed``; temperature <= 0 is
    argmax. The CPU route: the plain ``WaveNet.generate``."""
    params = pytree.tree_unflatten(weights, pytree.treespec_loads(weights_spec))
    return _net(net_config).generate(
        params, lc.shape[1], seed=int(seed), batch=lc.shape[0],
        gc_ids=gc_ids, lc=lc, temperature=temperature)


@wavenet_sample.register_kernel("cuda")
def _wavenet_sample_cuda(packed, weights, lc, seed, temperature, net_config,
                         weights_spec, gc_ids):
    """The CUDA route: one launch of the kernel from a fresh state."""
    batch, n_samples = lc.shape[:2]
    _, code, prev, rings = _net(net_config).generate_carry0(batch, lc.device)
    state = torch.stack([code, prev], dim=1).contiguous()
    return SAMPLER(dict(zip(PACKED_KEYS, packed)), lc.contiguous(), n_samples,
                   batch, temperature, int(seed), rings, state, 0)


@wavenet_sample.register_fake
def _wavenet_sample_fake(packed, weights, lc, seed, temperature, net_config,
                         weights_spec, gc_ids):
    return lc.new_empty(lc.shape[0], lc.shape[1], dtype=torch.int32)
