"""Serving latency at the decode's cap against the calibrated early stop.

    python -m nspeech_tpu_torch.cli.serve_latency --checkpoint CKPT_DIR \
        --threshold 0.18 --text "..." [--text ...]

Port of the JAX package's ``scripts/serve_latency.py``, with its flags and
JSON keys (``--device``, ``cuda`` by default, in place of ``--platform``).
Times text -> wav through the port's ``Synthesizer`` on a trained
checkpoint at two stop thresholds: 0.0 (the decode runs its whole
``max_iters`` budget, as a model with random weights always does) and
the calibrated value (``cli.calibrate_stop``). Each text is served once
to warm up, then the best of 3 requests is kept; on the card each
request is timed between two ``torch.cuda.synchronize()``. Per text: the
seconds, the decoder steps and the audio seconds; then the mean seconds
at each threshold and their ratio.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _bench(synth, texts, reps=3):
    def sync():
        if synth.device.type == "cuda":
            torch.cuda.synchronize(synth.device)

    rows = []
    for text in texts:
        synth.synthesize(text, want_features=False)  # warm-up
        best = float("inf")
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            wav, _, _ = synth.synthesize(text, want_features=False)
            sync()
            best = min(best, time.perf_counter() - t0)
        rows.append({"text": text, "sec": round(best, 4),
                     "decoder_steps": int(synth.last_decoder_steps),
                     "audio_sec": round(len(wav) / synth.cfg.sample_rate, 2)})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--threshold", type=float, required=True,
                   help="calibrated stop_threshold (see cli.calibrate_stop)")
    p.add_argument("--text", action="append", default=[])
    p.add_argument("--hparams", default="")
    p.add_argument("--device", default="cuda",
                   help="where the requests run: cuda (one card) or cpu")
    args = p.parse_args(argv)

    from nspeech_tpu_torch.serving import Synthesizer

    texts = args.text or ["the quick onyx goblin jumps over the lazy dwarf."]
    extra = ("," + args.hparams) if args.hparams else ""

    out = {}
    for label, thr in (("cap", 0.0), ("calibrated", args.threshold)):
        synth = Synthesizer.from_checkpoint(
            args.checkpoint, overrides=f"stop_threshold={thr}{extra}",
            device=args.device)
        out[label] = {"stop_threshold": thr, "rows": _bench(synth, texts)}
    cap = np.mean([r["sec"] for r in out["cap"]["rows"]])
    cal = np.mean([r["sec"] for r in out["calibrated"]["rows"]])
    out["mean_sec_cap"] = round(float(cap), 4)
    out["mean_sec_calibrated"] = round(float(cal), 4)
    out["speedup"] = round(float(cap / cal), 2) if cal > 0 else None
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
