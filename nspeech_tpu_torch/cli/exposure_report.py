"""Compare free-run (autoregressive) health across training runs.

    python -m nspeech_tpu_torch.cli.exposure_report --run ss0.0=RUN_A \
        --run ss0.5=RUN_B --out OUT_DIR [--audible-rms 0.05]

Port of the JAX package's ``scripts/exposure_report.py``, with its flags
and JSON keys. Reads each run's ``metrics.jsonl`` (written by
``cli.train --freerun-preview``) and writes a step-aligned table
(``report.json``) and a curve (``freerun_rms.png``) of ``freerun_rms``,
the serving-path canary of exposure bias: teacher-forced previews look
right while the free-running decoder emits silence. Built for the
scheduled-sampling comparison: the same config trained with
``scheduled_sampling_ratio=0.0`` and above, and when each run's free-run
output becomes (and stays) audible. ``--device`` is accepted as by every
CLI of the port; the report reads files only.
"""

from __future__ import annotations

import argparse
import json
import os


def load_freerun(run_dir: str) -> list[tuple[int, float, float]]:
    rows = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "freerun_rms" in rec:
                rows.append((int(rec["step"]), float(rec["freerun_rms"]),
                             float(rec.get("freerun_decoder_steps", 0))))
    return sorted(rows)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--run", action="append", required=True,
                        metavar="LABEL=DIR",
                        help="label=path-to-run-dir (repeatable)")
    parser.add_argument("--out", required=True,
                        help="output dir for freerun_rms.png + report.json")
    parser.add_argument("--audible-rms", type=float, default=0.05,
                        help="threshold below which a free-run preview is "
                             "counted as (near-)silent")
    parser.add_argument("--device", default="cuda",
                        help="accepted for the CLIs' common interface; the "
                             "report reads metrics files only")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    runs = {}
    for spec in args.run:
        label, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--run expects LABEL=DIR, got {spec!r}")
        runs[label] = load_freerun(path)
        if not runs[label]:
            raise SystemExit(f"{path}: no freerun_rms rows — was the run "
                             "launched with --freerun-preview?")

    report = {"audible_rms_threshold": args.audible_rms, "runs": {}}
    for label, rows in runs.items():
        audible = [s for s, rms, _ in rows if rms >= args.audible_rms]
        report["runs"][label] = {
            "points": [{"step": s, "freerun_rms": round(rms, 4)}
                       for s, rms, _ in rows],
            "first_audible_step": audible[0] if audible else None,
            "audible_fraction": round(len(audible) / len(rows), 3),
            "final_rms": round(rows[-1][1], 4),
        }

    from nspeech_tpu_torch.utils.plot import plot_curves

    series = [(label, [s for s, _, _ in rows], [r for _, r, _ in rows])
              for label, rows in runs.items()]
    steps = [s for _, xs, _ in series for s in xs]
    series.append((f"audible threshold ({args.audible_rms})",
                   [min(steps), max(steps)], [args.audible_rms] * 2))
    png = os.path.join(args.out, "freerun_rms.png")
    plot_curves(png, series, "training step", "free-run preview RMS")

    path = os.path.join(args.out, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["runs"], indent=1))
    print(f"wrote {png} and {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
