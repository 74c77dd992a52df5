"""Measure teacher-forced (GTA) against ground-truth mel mismatch.

    python -m nspeech_tpu_torch.cli.gta_mismatch --gta-dir GTA_DIR \
        --ljspeech CORPUS [--cache-dir CACHE] [--max-utts N]

Port of the JAX package's ``scripts/gta_mismatch.py``, with its flags and
JSON keys (``--device``, ``cuda`` by default, in place of ``--platform``).
The size of the distribution shift that GTA fine-tuning of the vocoder
exists to bridge: when the teacher-forced model's mels sit within about
the vocoder's own copy-synthesis error of the true mels, GTA fine-tuning
has nothing to learn. Reads the manifest of ``cli.export_gta``, the
exporting checkpoint's config, and each utterance's true mel
(``data/features.py`` ``process_utterance``, on the host, cached with
``--cache-dir``); the per-utterance mean |difference| over the overlap
is taken on ``--device`` in float64. Prints one JSON object: that
distribution over the export (mean, p50, p90, max), in the normalized
mel units of ``cli.vocoder_report``'s copy-synthesis ``mel_l1``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gta-dir", required=True)
    p.add_argument("--ljspeech")
    p.add_argument("--vctk")
    p.add_argument("--librispeech")
    p.add_argument("--arctic")
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--max-utts", type=int, default=0,
                   help="cap the measured utterances (0 = all)")
    p.add_argument("--device", default="cuda",
                   help="where the differences are taken: cuda (one card) or cpu")
    args = p.parse_args(argv)

    from nspeech_tpu_torch.data.features import process_utterance
    from nspeech_tpu_torch.data.gta import load_manifest
    from nspeech_tpu_torch.train import config_from_checkpoint

    device = torch.device(args.device)
    manifest = load_manifest(args.gta_dir)
    cfg, _model = config_from_checkpoint(manifest["checkpoint"])

    per_utt = []
    items = sorted(manifest["files"].items())
    if args.max_utts:
        items = items[: args.max_utts]
    for wav_path, npy_name in items:
        gta = np.load(os.path.join(args.gta_dir, npy_name))
        gt = process_utterance(wav_path, cfg, args.cache_dir).mel
        n = min(len(gta), len(gt))
        if n == 0:
            continue
        a = torch.from_numpy(gta[:n]).to(device, torch.float64)
        b = torch.from_numpy(gt[:n]).to(device, torch.float64)
        per_utt.append(float(torch.mean(torch.abs(a - b))))
    if not per_utt:
        print(json.dumps({"error": "no utterances measured"}))
        return 1
    arr = np.asarray(per_utt)
    out = {
        "n_utterances": len(arr),
        "mel_l1_mean": float(arr.mean()),
        "mel_l1_p50": float(np.percentile(arr, 50)),
        "mel_l1_p90": float(np.percentile(arr, 90)),
        "mel_l1_max": float(arr.max()),
        "checkpoint": manifest["checkpoint"],
        "step": manifest.get("step"),
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
