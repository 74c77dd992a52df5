"""Convert a reference (TensorFlow) checkpoint into the port's serving
checkpoint.

    python -m nspeech_tpu_torch.cli.import_reference_ckpt \
        --ckpt /data/ref_logs/model.ckpt-250000 --out /data/imported/run

Port of the JAX package's ``import_reference_ckpt.py``, with ``--device``
in place of ``--platform``. It reads the ``tf.train.Saver`` bundle with
the from-spec reader (``migrate/tfbundle.py``, no TensorFlow), detects
the reference model it holds, maps its variables onto the parameter tree
(``migrate/reference.py`` for WaveNet, ``migrate/tacotron.py`` for
Tacotron-1 and -2), checks the tree against the port's ``init`` for the
derived config, loading it onto ``--device`` (``cuda`` by default), and
writes ``<out>/ckpt/config.json`` (the run metadata) and
``<out>/ckpt/serving/<step>.npz`` (``train/checkpoint.py``), which
``cli.synthesize``, ``cli.generate_wavenet``, ``cli.eval`` and
``cli.demo_server`` serve with no further flags.

Most hparams come from the weight shapes. A WaveNet's factorization of
its layers into ``dilations_length`` x ``dilations_depth`` does not (only
their product does): pass them if the run deviated from the stock 10 x 5.
Audio-analysis hparams (sample_rate and the like) are not in the graph:
pass them with ``--hparams`` when they deviate from the defaults.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Optional

import numpy as np
import torch

from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.migrate import (check_dilations, detect_model,
                                       import_tacotron, import_wavenet)
from nspeech_tpu_torch.models import WaveNet, create_model
from nspeech_tpu_torch.train.checkpoint import save_serving_checkpoint


def _parse_step(step: Optional[int], src) -> int:
    if step is not None:
        return step
    m = re.search(r"-(\d+)$", os.path.basename(src)) if isinstance(src, str) else None
    return int(m.group(1)) if m else 0


def _device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to convert on the host)")
    return device


def _overlay(cfg, derived: dict, hparams: str):
    for key, value in derived.items():
        setattr(cfg, key, value)
    return cfg.parse(hparams)


def _check_tree(bridge, what: str) -> None:
    """The imported tree bridged onto the port's ``init`` tree (same
    leaves, same shapes) on the device; a mismatch exits."""
    try:
        bridge()
    except ValueError as e:
        raise SystemExit(f"imported {what} tree does not match init for the "
                         f"derived config: {e}")


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_n_params(v) for v in tree)
    return int(np.size(tree))


def import_checkpoint(src, out: str, model_name: Optional[str] = None,
                      dilations_length: Optional[int] = None,
                      dilations_depth: Optional[int] = None,
                      hparams: str = "", step: Optional[int] = None,
                      device="cuda") -> str:
    """Import ``src`` (a checkpoint prefix, or a ``{reference name:
    ndarray}`` mapping as the importers take it) into ``<out>/ckpt``;
    returns that directory. The arguments are the CLI's flags."""
    device = _device(device)
    if model_name is None:
        model_name = detect_model(src)
        print(f"Detected reference model: {model_name}")
    step = _parse_step(step, src)
    ckpt_dir = os.path.join(os.path.abspath(out), "ckpt")
    if model_name == "wavenet":
        params, derived = import_wavenet(src)
        n_layers = derived.pop("n_layers")
        cfg = load_config("wavenet")
        length = dilations_length or int(cfg.dilations_length)
        depth = dilations_depth or int(cfg.dilations_depth)
        check_dilations(n_layers, length, depth)
        derived["dilations_length"] = length
        derived["dilations_depth"] = depth
        # serving reads num_speakers from the metadata; the gc table's
        # cardinality is that speaker count
        if derived.get("gc_category_cardinality"):
            derived["num_speakers"] = derived["gc_category_cardinality"]
        cfg = _overlay(cfg, derived, hparams)
        _check_tree(lambda: convert.wavenet_params(WaveNet(cfg), params, device),
                    "param")
        save_serving_checkpoint(ckpt_dir, step, "wavenet", cfg, params)
        print(f"Imported {_n_params(params):,} parameters "
              f"({n_layers} dilated layers, "
              f"{'biases, ' if derived['use_biases'] else ''}"
              f"gc={derived['gc_channels']}, lc={derived['lc_channels']}) "
              f"-> {ckpt_dir} at step {step}")
        print(f"Serve with e.g.: python -m nspeech_tpu_torch.cli.generate_wavenet "
              f"{ckpt_dir} --samples 16000")
        return ckpt_dir
    params, bn_state, derived = import_tacotron(src, model_name)
    cfg = _overlay(load_config(model_name), derived, hparams)
    model = create_model(model_name, cfg)
    _check_tree(lambda: convert.tacotron_variables(model, params, bn_state,
                                                   device),
                "param or batch-norm state")
    save_serving_checkpoint(ckpt_dir, step, model_name, cfg, params, bn_state)
    print(f"Imported {model_name}: {_n_params(params):,} parameters "
          f"(attention={derived['attention_type']}, "
          f"r={derived['outputs_per_step']}, "
          f"speakers={derived['num_speakers']}) "
          f"-> {ckpt_dir} at step {step}")
    print(f"Serve with e.g.: python -m nspeech_tpu_torch.cli.synthesize "
          f"--checkpoint {ckpt_dir} --text \"hello world.\"")
    return ckpt_dir


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Import a reference tf.train.Saver checkpoint "
                    "(WaveNet, Tacotron-1 or Tacotron-2)")
    parser.add_argument("--ckpt", required=True,
                        help="checkpoint prefix (path of the .index file "
                             "minus '.index')")
    parser.add_argument("--out", required=True,
                        help="output run directory (created)")
    parser.add_argument("--model", default=None,
                        choices=["taco1", "taco2", "wavenet"],
                        help="reference model in the checkpoint "
                             "(default: detected from variable names)")
    parser.add_argument("--dilations-length", type=int, default=None,
                        help="WaveNet: training-time dilations_length "
                             "(default: the wavenet preset's if consistent)")
    parser.add_argument("--dilations-depth", type=int, default=None,
                        help="WaveNet: training-time dilations_depth")
    parser.add_argument("--hparams", default="",
                        help="extra k=v,... overrides stored in the run "
                             "metadata (e.g. sample_rate=22050)")
    parser.add_argument("--step", type=int, default=None,
                        help="step number for the written checkpoint "
                             "(default: parsed from the prefix, else 0)")
    parser.add_argument("--device", default="cuda",
                        help="where the imported tree is checked: cuda "
                             "(one card) or cpu")
    args = parser.parse_args(argv)
    prefix = args.ckpt
    if prefix.endswith(".index"):
        prefix = prefix[:-len(".index")]
    import_checkpoint(prefix, args.out, args.model, args.dilations_length,
                      args.dilations_depth, args.hparams, args.step, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
