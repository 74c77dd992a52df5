"""Free-run one set of trained Tacotron-2 weights through both packages.

    python docs/torch_alignment/compare_freerun.py WEIGHTS_DIR \
        [--text T ...] [--float32] [--out OUT.json]

WEIGHTS_DIR is what ``run_alignment.py --export-weights`` writes on the
card: the run's ``config.json`` and ``serving_bf16.npz`` (the serving
parameters rounded to bf16, without the linear spectrogram's branch).
The branch (``params/expand``, ``params/linear_proj``) is filled from the
port's ``init(0)``: the decode and its alignment never read it, only
Griffin-Lim's input does. The same weights then decode each text
autoregressively through the port's ``Synthesizer`` and the JAX
package's, both on the CPU, under the run's compute dtype (bf16) or
float32 with ``--float32``. Per text and package it prints the decoder
steps, the attention path (argmax input position per decoder step) at
its start and the furthest position it reaches, the mean peak attention
weight and the mean of the decoded mel frames; then the largest
difference between the two packages' alignments and mels. A decode that follows the text
reaches the text's last positions; one parked at the start does not.

This script imports both packages, as the parity tests do; it is a
check run beside the port, not part of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

NOVEL = os.path.join(ROOT, "docs", "alignment", "report_novel_texts.json")


def load_weights(weights_dir: str) -> dict:
    """Flat ``params/...`` and ``bn_state/...`` float32 arrays, the
    missing branch from the port's ``init(0)``."""
    import torch

    from nspeech_tpu_torch.models import create_model
    from nspeech_tpu_torch.train.checkpoint import _flatten
    from nspeech_tpu_torch.train.metadata import config_from_checkpoint

    cfg, name = config_from_checkpoint(weights_dir)
    params, bn_state = create_model(name, cfg).init(0)
    flat: dict = {}
    _flatten(params, "params", flat)
    _flatten(bn_state, "bn_state", flat)
    with np.load(os.path.join(weights_dir, "serving_bf16.npz")) as z:
        for key in z.files:
            if key == "step":
                continue
            value = z[key]
            if key.startswith("params/"):
                value = torch.from_numpy(value).view(torch.bfloat16).float().numpy()
            if key not in flat or flat[key].shape != value.shape:
                raise ValueError(f"{key}: not a leaf of the port's {name}")
            flat[key] = value
    return flat


def summary(align: np.ndarray, steps: int, n_text: int, mel: np.ndarray) -> dict:
    """``mel``: the decoded frames only."""
    path = np.argmax(align[:n_text, :steps], axis=0)
    return {"decoder_steps": int(steps), "path_start": path[:12].tolist(),
            "furthest_position": int(path.max()), "text_positions": n_text,
            "sharpness": round(float(np.mean(np.max(align[:, :steps], axis=0))), 4),
            "mel_mean": round(float(np.mean(mel)), 4)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("weights_dir")
    p.add_argument("--text", action="append", default=[])
    p.add_argument("--float32", action="store_true",
                   help="decode in float32 in both packages")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from nspeech_tpu.models import create_model as j_create
    from nspeech_tpu.serving import Synthesizer as JSynthesizer
    from nspeech_tpu.train import config_from_checkpoint as j_config
    from nspeech_tpu_torch.serving import Synthesizer
    from nspeech_tpu_torch.train.checkpoint import _unflatten

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    texts = args.text or [t["text"] for t in json.load(open(NOVEL))["texts"]]
    overrides = "compute_dtype=float32" if args.float32 else ""
    flat = load_weights(args.weights_dir)
    with tempfile.TemporaryDirectory() as tmp:
        # the port's serving checkpoint of these weights
        os.makedirs(os.path.join(tmp, "serving"))
        with open(os.path.join(args.weights_dir, "config.json")) as f:
            meta = f.read()
        with open(os.path.join(tmp, "config.json"), "w") as f:
            f.write(meta)
        np.savez(os.path.join(tmp, "serving", "1.npz"), **flat)
        port = Synthesizer.from_checkpoint(tmp, overrides=overrides, device="cpu")
        cfg, name = j_config(tmp, overrides=overrides)
    tree = {k: jax.tree_util.tree_map(jax.numpy.asarray, _unflatten(flat, k))
            for k in ("params", "bn_state")}
    jsyn = JSynthesizer(cfg).set_variables(tree["params"], tree["bn_state"],
                                           model=j_create(name, cfg))

    report = {"weights": os.path.abspath(args.weights_dir),
              "compute_dtype": port.cfg.compute_dtype, "texts": []}
    for text in texts:
        n_text = len(text) + 1  # + EOS
        entry = {"text": text}
        aligns, mels = {}, {}
        for label, syn in (("port", port), ("jax", jsyn)):
            _, mel, _ = syn.synthesize(text, want_features="mel")
            align = np.asarray(syn.last_alignment, np.float32)
            steps = int(syn.last_decoder_steps)
            mel = np.asarray(mel, np.float32)[: steps * int(cfg.outputs_per_step)]
            entry[label] = summary(align, steps, n_text, mel)
            aligns[label], mels[label] = align[:, :steps], mel
        same = aligns["port"].shape == aligns["jax"].shape
        entry["max_align_diff"] = (float(np.max(np.abs(aligns["port"] - aligns["jax"])))
                                   if same else None)
        n = min(len(mels["port"]), len(mels["jax"]))
        entry["max_mel_diff"] = float(np.max(np.abs(mels["port"][:n] - mels["jax"][:n])))
        report["texts"].append(entry)
        print(json.dumps(entry), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
