"""Produce the alignment-evidence package for a training run.

    python -m nspeech_tpu_torch.cli.alignment_report --run-dir LOG_DIR/RUN \
        --out OUT_DIR --text "deep wave tone." [--text ...] [--speakers 0,1]

Port of the JAX package's ``scripts/alignment_report.py``, with its flags
and JSON keys (``--device``, ``cuda`` by default, in place of
``--platform``). Reads a run's ``metrics.jsonl`` and checkpoint and
writes, into ``--out``:

- ``sharpness_curve.png``: attention_sharpness over training steps, per
  summary and smoothed (the metric that collapses toward 1/T_in when
  alignment fails);
- per text ``eval-N.wav``, ``eval-N-align.png`` and ``eval-N-mel.png``
  (``eval-N-spkK-*`` with ``--speakers``): AUTOREGRESSIVE synthesis (no
  teacher forcing) through the port's ``Synthesizer``;
- ``report.json``: the final smoothed sharpness and, per text, the
  decoder steps used, seconds, RMS, a monotonicity score of the
  attention path (the fraction of decoder steps whose argmax input
  position does not move back by more than one) and the mean peak
  attention weight. With ``--speakers``, per speaker also the median F0
  and spectral centroid, and per text the voice ratios against the first
  speaker, null unless both decodes reach an RMS of MIN_VOICED_RMS.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nspeech_tpu_torch.utils.audio_metrics import (median_f0, monotonicity,
                                                   smooth_sharpness,
                                                   spectral_centroid,
                                                   spectral_shift_ratio)

# a decode below this RMS measures noise, not a voice: its ratios are null
MIN_VOICED_RMS = 0.05


def read_metric(run_dir: str, key: str):
    """(steps, values) of ``key`` in the run's ``metrics.jsonl``."""
    steps, values = [], []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if key in row:
                steps.append(row["step"])
                values.append(row[key])
    return steps, values


def sharpness_curve(run_dir: str, out_png: str) -> float:
    """Plot the run's attention sharpness, raw and smoothed; returns the
    last smoothed value."""
    from nspeech_tpu_torch.utils.plot import plot_curves

    steps, sharp = read_metric(run_dir, "attention_sharpness")
    if not sharp:
        raise SystemExit(f"{run_dir}/metrics.jsonl has no attention_sharpness "
                         "rows: train past a --summary-interval first")
    k, smooth = smooth_sharpness(sharp)
    plot_curves(out_png, [("per summary", steps, sharp),
                          ("smoothed", steps[k - 1:], smooth)],
                "training step", "attention sharpness (mean max alignment weight)")
    return float(smooth[-1]) if len(smooth) else float("nan")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--run-dir", required=True,
                        help="log_dir/<run> containing metrics.jsonl + ckpt/")
    parser.add_argument("--out", required=True)
    parser.add_argument("--text", action="append", default=[])
    parser.add_argument("--speakers", default="",
                        help="comma-separated speaker ids: synthesize every "
                             "--text for EVERY listed speaker and report "
                             "per-speaker median F0 (speaker-conditioning "
                             "evidence for multi-speaker checkpoints)")
    parser.add_argument("--stop-threshold", type=float, default=0.02)
    parser.add_argument("--hparams", default="",
                        help="extra k=v overrides for the synthesizer "
                             "(e.g. attention_win_fwd=4)")
    parser.add_argument("--device", default="cuda",
                        help="where the decodes run: cuda (one card) or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    report = {"final_sharpness_smoothed": sharpness_curve(
        args.run_dir, os.path.join(args.out, "sharpness_curve.png"))}

    if args.text:
        from nspeech_tpu_torch.dsp.wavio import save_wav
        from nspeech_tpu_torch.serving import Synthesizer
        from nspeech_tpu_torch.utils import plot

        ckpt = os.path.join(args.run_dir, "ckpt")
        overrides = "stop_threshold=%g" % args.stop_threshold
        if args.hparams:
            overrides += "," + args.hparams
        synth = Synthesizer.from_checkpoint(ckpt, overrides=overrides,
                                            device=args.device)
        sr = synth.cfg.sample_rate
        speakers = ([int(s) for s in args.speakers.split(",")]
                    if args.speakers else [-1])
        report["texts"] = []
        for i, text in enumerate(args.text):
            per_speaker = {}
            for spk in speakers:
                wav, mel, _ = synth.synthesize(text, speaker_id=spk)
                align = synth.last_alignment  # [T_in, S]
                steps = int(synth.last_decoder_steps)
                tag = "eval-%d" % i if spk < 0 else "eval-%d-spk%d" % (i, spk)
                base = os.path.join(args.out, tag)
                save_wav(wav, base + ".wav", sr)
                n_text = len(text) + 1  # + EOS
                plot.plot_alignment(align[:n_text, :steps + 2],
                                    base + "-align.png",
                                    info="autoregressive: %r" % text)
                plot.plot_specgram(mel, base + "-mel.png", "mel")
                per_speaker[spk] = {
                    "decoder_steps": steps,
                    "seconds": round(len(wav) / sr, 2),
                    # near-zero RMS: the decoder free-ran to silence, which
                    # alignment numbers alone do not show
                    "rms": round(float(np.sqrt(np.mean(wav ** 2))), 4),
                    "monotonicity": round(
                        monotonicity(align[:n_text], steps), 4),
                    "sharpness": round(float(np.mean(np.max(
                        align[:, :steps], axis=0))), 4),
                }
                if speakers != [-1]:
                    per_speaker[spk]["median_f0_hz"] = round(median_f0(wav, sr), 1)
                    per_speaker[spk]["spectral_centroid_hz"] = round(
                        spectral_centroid(wav, sr), 1)
                    per_speaker[spk]["_wav"] = wav
            entry = {"text": text}
            if speakers == [-1]:
                entry.update(per_speaker[-1])
            else:
                wavs = [per_speaker[s].pop("_wav") for s in speakers]
                entry["per_speaker"] = {str(k): v for k, v in per_speaker.items()}
                voiced = [per_speaker[s]["rms"] >= MIN_VOICED_RMS
                          for s in speakers]

                def _gate(vals):
                    return [v if voiced[0] and voiced[i] else None
                            for i, v in enumerate(vals)]

                f0s = [per_speaker[s]["median_f0_hz"] for s in speakers]
                if f0s[0] > 0:
                    entry["f0_ratio_vs_first_speaker"] = _gate(
                        [round(f / f0s[0], 3) for f in f0s])
                entry["spectral_ratio_vs_first_speaker"] = _gate(
                    [round(spectral_shift_ratio(wavs[0], w, sr), 3)
                     for w in wavs])
                cents = [per_speaker[s]["spectral_centroid_hz"] for s in speakers]
                if cents[0] > 0:
                    entry["centroid_ratio_vs_first_speaker"] = _gate(
                        [round(c / cents[0], 3) for c in cents])
                if not all(voiced):
                    entry["ratio_note"] = (
                        "null ratios: decode(s) below rms %.2f — spectral "
                        "estimators would measure noise" % MIN_VOICED_RMS)
            report["texts"].append(entry)

    path = os.path.join(args.out, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
