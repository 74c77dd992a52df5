#!/usr/bin/env python
"""Export a JAX (Orbax) checkpoint to the PyTorch port's serving checkpoint.

    python scripts/export_torch_checkpoint.py CKPT_DIR OUT_DIR \
        [--model NAME] [--step N] [--hparams k=v,...] [--platform cpu]

Runs where the JAX package runs. It restores the serving parameters as
the JAX package's serving entry points do (``config_from_checkpoint``, then
``load_serving_params``: the EMA average when the run kept one) and writes
the layout that ``nspeech_tpu_torch.train.load_serving_params`` reads:

    OUT_DIR/config.json          the run metadata (same schema)
    OUT_DIR/serving/<step>.npz   params/<path> (and bn_state/<path>) leaves

Each archive key is the ``/``-joined path of a leaf in the parameter tree
(list items by index), each value a float32 array. This is how a trained
checkpoint reaches a machine without orbax or a zstd decoder: the Orbax
checkpoints are OCDBT with zstd-compressed chunks. The port does not
import this script.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _flatten(tree: Any, path: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{path}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{path}/{i}", out)
    elif tree is not None:
        out[path] = np.asarray(tree, np.float32)


def export(ckpt_dir: str, out_dir: str, model_name: Optional[str] = None,
           step: Optional[int] = None, overrides: str = "") -> str:
    """Write OUT_DIR's ``config.json`` and ``serving/<step>.npz``; returns
    the archive's path."""
    from nspeech_tpu.models import create_model
    from nspeech_tpu.train import (CheckpointManager, config_from_checkpoint,
                                   load_run_metadata, load_serving_params,
                                   save_run_metadata)

    cfg, name = config_from_checkpoint(ckpt_dir, model_name, overrides)
    if step is None:
        mgr = CheckpointManager(ckpt_dir)
        step = mgr.latest_step()
        mgr.close()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    model = create_model(name, cfg)
    params, bn_state = load_serving_params(ckpt_dir, model, cfg, name,
                                           step=step)
    meta = load_run_metadata(ckpt_dir) or {}
    speaker_map = None
    if "speaker_map" in meta:
        speaker_map = {(ds, spk): idx for ds, spk, idx in meta["speaker_map"]}
    save_run_metadata(out_dir, name, cfg, speaker_map=speaker_map)
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params", flat)
    _flatten(bn_state, "bn_state", flat)
    serving = os.path.join(out_dir, "serving")
    os.makedirs(serving, exist_ok=True)
    path = os.path.join(serving, f"{int(step)}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    return path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoint", help="Orbax checkpoint directory")
    parser.add_argument("out", help="directory of the port's checkpoint")
    parser.add_argument("--model", default=None,
                        help="model name (default: the run metadata's)")
    parser.add_argument("--step", type=int, default=None,
                        help="training step (default: the latest)")
    parser.add_argument("--hparams", default="",
                        help="k=v,... overrides applied last")
    parser.add_argument("--platform", default=None)
    args = parser.parse_args(argv)
    from nspeech_tpu.utils.platform import set_platform

    set_platform(args.platform)
    path = export(args.checkpoint, args.out, args.model, args.step,
                  args.hparams)
    print("Wrote %s" % path)


if __name__ == "__main__":
    main()
