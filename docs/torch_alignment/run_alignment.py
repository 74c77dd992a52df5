"""The port's alignment run on one CUDA card, from corpus to reports.

    python3 docs/torch_alignment/run_alignment.py [--utts 3000] \
        [--budget-s 3200] [--max-steps 2000] [--min-steps 1000] \
        [--work build/aln] [--out build/aln/out]

The recipe of ``docs/alignment/README.md`` ("Setup", "Guided run") through
the port's CLIs, in one process on the card:

1. ``cli.make_alignment_corpus WORK/corpus UTTS 29 chars`` (random letter
   strings, so that only per-step attention lowers the loss);
2. ``cli.preprocess --cache-dir WORK/cache`` (8 workers);
3. ``cli.train --model taco2`` at batch 32 with ``--device-cache 1
   --log-every 5 --summary-interval 50 --checkpoint-interval 250
   --freerun-preview --hparams HPARAMS`` for PROBE_STEPS steps; the warm
   sec/step of steps 6-PROBE_STEPS (the card synchronized at 5 and at
   PROBE_STEPS, where the trainer reads the loss anyway) sizes the run:
   the largest multiple of 250 up to ``--max-steps`` that fits the time
   left of ``--budget-s`` after REPORT_RESERVE_S for the reports. When
   fewer than ``--min-steps`` fit, a second run without the device cache
   probes again (every cached batch is padded to the corpus's longest
   utterance, the feeder's batches to their own), and sizes the run if
   it fits;
4. the same command resumed to that step (peak memory read after it);
5. ``cli.alignment_report`` on the three novel texts of
   ``docs/alignment/report_novel_texts.json`` and the corpus's first
   sentence, ``cli.calibrate_stop --run-dir``, ``cli.serve_latency`` at the
   cap and the calibrated threshold, ``cli.exposure_report`` on the run.

Writes to ``--out``: ``summary.json`` (the card, times, sec/step, peak
memory, the losses and smoothed sharpness at steps 250, 500, 1000 and
2000), the run's ``metrics.jsonl`` and ``train.log``, its teacher-forced
and free-run alignment PNGs at each checkpoint, and the reports'
directories. The run directory stays in ``--work``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

HPARAMS = ("outputs_per_step=2,guided_attention_weight=10,"
           "guided_attention_sigma=0.25,initial_learning_rate=1e-3,"
           "compute_dtype=bfloat16")
PROBE_STEPS = 20
REPORT_RESERVE_S = 300       # reports, calibration, latency, copies
CKPT_OVERHEAD_S = 15         # a checkpoint's save, artifacts and free-run preview
RESTART_S = 90               # the trainer's start: model, state, the device cache
MARK_STEPS = (250, 500, 1000, 2000)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run_cli(main, argv, out_path=None) -> str:
    """A CLI's ``main(argv)`` in this process; its stdout (also written
    to ``out_path``) is returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc not in (None, 0):
        raise SystemExit(f"{main.__module__} {argv} exited {rc}")
    text = buf.getvalue()
    if out_path:
        with open(out_path, "w") as f:
            f.write(text)
    return text


def json_of(text: str):
    return json.JSONDecoder().raw_decode(text[text.index("{"):])[0]


def at_steps(rows, key, steps):
    """{step: value of ``key`` at the logged step nearest to it}."""
    pts = [(r["step"], r[key]) for r in rows if key in r]
    out = {}
    for s in steps:
        if pts and max(p[0] for p in pts) >= s - 50:
            out[str(s)] = min(pts, key=lambda p: abs(p[0] - s))[1]
    return out


def export_weights(ckpt: str, out: str) -> None:
    """The latest serving archive of ``ckpt`` as ``out/serving_bf16.npz``
    (parameters as the int16 bits of their bf16 rounding, which the bf16
    policy serves anyway; batch-norm state in float32) beside its
    ``config.json``, without ``params/expand`` and ``params/linear_proj``:
    the free-run decode and its alignment do not read them, and the rest
    fits in 64 MiB."""
    import numpy as np
    import torch

    step = max(int(f[:-4]) for f in os.listdir(os.path.join(ckpt, "serving"))
               if f.endswith(".npz"))
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(ckpt, "config.json"), out)
    kept = {}
    with np.load(os.path.join(ckpt, "serving", f"{step}.npz")) as z:
        for key in z.files:
            if key.startswith(("params/expand/", "params/linear_proj/")):
                continue
            value = z[key]
            if key.startswith("params/"):
                value = (torch.from_numpy(np.ascontiguousarray(value, np.float32))
                         .to(torch.bfloat16).view(torch.int16).numpy())
            kept[key] = value
    np.savez(os.path.join(out, "serving_bf16.npz"), step=np.int64(step), **kept)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--utts", type=int, default=3000)
    p.add_argument("--budget-s", type=float, default=3200.0)
    p.add_argument("--max-steps", type=int, default=2000)
    p.add_argument("--min-steps", type=int, default=1000)
    p.add_argument("--work", default=os.path.join(ROOT, "build", "aln"))
    p.add_argument("--out", default=os.path.join(ROOT, "build", "aln", "out"))
    p.add_argument("--export-weights", action="store_true",
                   help="also write OUT/weights: config.json and the last "
                        "step's serving weights without the linear "
                        "spectrogram's branch (expand, linear_proj) in bf16, "
                        "for docs/torch_alignment/compare_freerun.py")
    p.add_argument("--checkpoint-interval", type=int, default=250)
    p.add_argument("--summary-interval", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="cuda; cpu (with tiny --extra-hparams) tries the "
                        "script out on the host")
    p.add_argument("--extra-hparams", default="",
                   help="',k=v,...' appended to the recipe's hparams")
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    from nspeech_tpu_torch.cli import (alignment_report, calibrate_stop,
                                       exposure_report, make_alignment_corpus,
                                       preprocess, serve_latency)
    from nspeech_tpu_torch.cli import train as train_cli
    from nspeech_tpu_torch.utils.audio_metrics import smooth_sharpness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: this run trains on the card", file=sys.stderr)
        return 1

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    card = card_line() if args.device == "cuda" else "cpu"
    print(card, flush=True)
    os.makedirs(args.out, exist_ok=True)
    corpus = os.path.join(args.work, "corpus")
    cache = os.path.join(args.work, "cache")
    logs = os.path.join(args.work, "logs")
    summary = {"card": card, "torch": torch.__version__, "utterances": args.utts,
               "hparams": HPARAMS + args.extra_hparams}

    def note(key, value):
        summary[key] = value
        print(f"{key}: {value}", flush=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)

    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(corpus, "metadata.csv")):
        run_cli(make_alignment_corpus.main, [corpus, str(args.utts), "29", "chars"])
    note("corpus_s", round(time.perf_counter() - t0, 1))
    t0 = time.perf_counter()
    run_cli(preprocess.main, ["--ljspeech", corpus, "--model", "taco2",
                              "--cache-dir", cache, "--num-workers", "8",
                              "--hparams", HPARAMS + args.extra_hparams])
    note("preprocess_s", round(time.perf_counter() - t0, 1))

    marks = {}
    real_build = train_cli.build_tacotron_train_step

    def timed_build(*a, **kw):
        step_fn = real_build(*a, **kw)
        calls = [0]

        def step(state, batch, generator):
            out = step_fn(state, batch, generator)
            calls[0] += 1
            if calls[0] in (5, PROBE_STEPS):     # the trainer syncs here too
                sync()
                marks[calls[0]] = time.perf_counter()
            return out

        return step

    def command(name, device_cache):
        argv = ["--model", "taco2", "--ljspeech", corpus, "--cache-dir", cache,
                "--log-dir", logs, "--name", name, "--log-every", "5",
                "--summary-interval", str(args.summary_interval),
                "--checkpoint-interval", str(args.checkpoint_interval),
                "--freerun-preview", "--device", args.device,
                "--hparams", HPARAMS + args.extra_hparams]
        return argv + (["--device-cache", "1"] if device_cache else [])

    def probe(name, device_cache):
        """Warm sec/step of steps 6-PROBE_STEPS of a new run."""
        train_cli.build_tacotron_train_step = timed_build
        t0 = time.perf_counter()
        try:
            train_cli.main(command(name, device_cache)
                           + ["--max-steps", str(PROBE_STEPS)])
        finally:
            train_cli.build_tacotron_train_step = real_build
        sec = (marks[PROBE_STEPS] - marks[5]) / (PROBE_STEPS - 5)
        tag = "device_cache" if device_cache else "feeder"
        note(f"probe_{tag}_wall_s", round(time.perf_counter() - t0, 1))
        note(f"probe_{tag}_sec_per_step", round(sec, 4))
        return sec

    def plan(sec_step):
        """The most steps, a multiple of 250, that fit the time left (a
        restart of the trainer, ~RESTART_S, and a checkpoint's overhead
        every --checkpoint-interval steps counted)."""
        left = (args.budget_s - (time.perf_counter() - t_start)
                - REPORT_RESERVE_S - RESTART_S)
        per_step = sec_step + CKPT_OVERHEAD_S / args.checkpoint_interval
        return min(args.max_steps, int(left / per_step) // 250 * 250)

    name, device_cache = "aln", True
    steps = plan(probe(name, device_cache))
    if steps < args.min_steps and device_cache:
        # every cached batch is padded to the corpus's longest utterance;
        # the feeder's batches to their own
        note("device_cache_steps_fit", steps)
        name, device_cache = "aln_feeder", False
        steps = plan(probe(name, device_cache))
    note("device_cache", device_cache)
    note("planned_steps", steps)
    if steps < args.min_steps:
        print(f"{steps} steps fit the budget, fewer than --min-steps "
              f"{args.min_steps}: stopping after the probe", file=sys.stderr)
        return 2
    run = os.path.join(logs, name)

    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_cli.main(command(name, device_cache) + ["--max-steps", str(steps)])
    wall = time.perf_counter() - t0
    note("train_wall_s", round(wall, 1))
    note("train_sec_per_step_incl_checkpoints",
         round(wall / (steps - PROBE_STEPS), 4))
    if args.device == "cuda":
        note("peak_memory_gib", round(torch.cuda.max_memory_allocated() / 2**30, 3))
        note("peak_reserved_gib", round(torch.cuda.max_memory_reserved() / 2**30, 3))

    rows = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    sharp = [(r["step"], r["attention_sharpness"]) for r in rows
             if "attention_sharpness" in r]
    k, smooth = smooth_sharpness([v for _, v in sharp])
    smooth_rows = [{"step": s, "smoothed": float(v)}
                   for (s, _), v in zip(sharp[k - 1:], smooth)]
    note("steps", max(r["step"] for r in rows))
    for key in ("loss", "loss_mel", "loss_guided_attention", "attention_sharpness",
                "freerun_rms"):
        note(key + "_at", at_steps(rows, key, MARK_STEPS))
    note("smoothed_sharpness_at", at_steps(smooth_rows, "smoothed", MARK_STEPS))
    note("smoothing_window", k)

    for fname in ("metrics.jsonl", "train.log"):
        shutil.copy(os.path.join(run, fname), args.out)
    for path in sorted(glob.glob(os.path.join(run, "step-*-align.png"))):
        shutil.copy(path, args.out)      # -align and -freerun-align

    if args.export_weights:
        export_weights(os.path.join(run, "ckpt"), os.path.join(args.out, "weights"))

    # -- the reports: each runs, a failure is recorded and fails the script
    failed = []

    def report(key, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except (Exception, SystemExit) as e:   # a CLI's exit included
            failed.append(key)
            note(key + "_error", repr(e))
        note(key + "_s", round(time.perf_counter() - t0, 1))

    novel = [t["text"] for t in json.load(open(os.path.join(
        ROOT, "docs", "alignment", "report_novel_texts.json")))["texts"]]
    with open(os.path.join(corpus, "metadata.csv")) as f:
        train_text = f.readline().split("|")[1]
    ckpt = os.path.join(run, "ckpt")
    report("alignment_report", lambda: note("alignment_report", json_of(run_cli(
        alignment_report.main,
        ["--run-dir", run, "--out", os.path.join(args.out, "alignment_report"),
         "--device", args.device]
        + sum([["--text", t] for t in novel + [train_text]], [])))))
    report("calibrate_stop", lambda: note("calibrated_threshold", float(json_of(
        run_cli(calibrate_stop.main, ["--run-dir", ckpt, "--device", args.device],
                os.path.join(args.out, "calibrate_stop.json")))["threshold"])))
    report("serve_latency", lambda: note("serve_latency", json_of(run_cli(
        serve_latency.main,
        ["--checkpoint", ckpt, "--device", args.device, "--threshold",
         repr(summary.get("calibrated_threshold", 0.0))]
        + sum([["--text", t] for t in novel], []),
        os.path.join(args.out, "serve_latency.json")))))
    report("exposure_report", lambda: run_cli(exposure_report.main, [
        "--run", f"aln={run}", "--out", os.path.join(args.out, "exposure_report")]))
    note("total_s", round(time.perf_counter() - t_start, 1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
