"""Calibrate the decoder's early-stop threshold.

    python -m nspeech_tpu_torch.cli.calibrate_stop --ljspeech CORPUS \
        [--cache-dir CACHE] [--hparams k=v,...] [--apply CKPT_DIR]
    python -m nspeech_tpu_torch.cli.calibrate_stop --run-dir CKPT_DIR \
        [--text SENTENCE ...] [--apply CKPT_DIR] [--device cpu]

Port of the JAX package's ``scripts/calibrate_stop.py``, with its flags
(``--device`` in place of ``--platform``). The corpus mode computes the
silence-floor and speech-danger statistics over the corpus mels
(``data/features.py`` ``process_utterance``, cached with ``--cache-dir``;
``train/stopcal.py`` ``stop_statistics``). The ``--run-dir`` mode decodes
sentences with the trained model at its full step budget through the
port's ``Synthesizer`` (on the card unless ``--device cpu``) and measures
what the decoder emits after speech against what it emits within it
(``stop_statistics_from_decodes``). Both print the recommendation as
JSON; ``--apply`` writes it into a run's ``config.json``, which every
serving entry point reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_TEXTS = [
    "the quick onyx goblin jumps over the lazy dwarf.",
    "a b c d e f g h i j k l m.",
    "this sentence exists to measure where speech ends.",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ljspeech")
    p.add_argument("--vctk")
    p.add_argument("--librispeech")
    p.add_argument("--arctic")
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--hparams", default="")
    p.add_argument("--from-run", default=None,
                   help="ckpt dir whose run metadata supplies the hparams")
    p.add_argument("--max-utts", type=int, default=400)
    p.add_argument("--tail", type=int, default=5)
    p.add_argument("--apply", default=None,
                   help="ckpt dir whose config.json gets the threshold")
    p.add_argument("--run-dir", default=None,
                   help="calibrate from the trained model's own decodes "
                        "(ckpt dir or log_dir/<run>): synthesizes --text "
                        "sentences at the full step budget and measures "
                        "post-speech against in-speech emission levels "
                        "(the right source on trimmed corpora)")
    p.add_argument("--text", action="append", default=[],
                   help="sentences for --run-dir calibration decodes")
    p.add_argument("--speakers", default="",
                   help="comma-separated speaker ids for --run-dir decodes")
    p.add_argument("--device", default="cuda",
                   help="where --run-dir decodes: cuda (one card) or cpu")
    return p


def _report(stats, apply_dir) -> None:
    from nspeech_tpu_torch.train.stopcal import apply_threshold_to_run

    print(json.dumps(stats, indent=1))
    if stats["threshold"] <= 0.0:
        print("no safe threshold (separation %.2f <= 1.5) — early stop "
              "stays disabled" % stats["separation"], file=sys.stderr)
    if apply_dir:
        path = apply_threshold_to_run(apply_dir, stats["threshold"])
        print("applied stop_threshold=%.4g -> %s"
              % (stats["threshold"], path), file=sys.stderr)


def from_decodes(args) -> dict:
    from nspeech_tpu_torch.config import stft_params
    from nspeech_tpu_torch.serving import Synthesizer
    from nspeech_tpu_torch.train.stopcal import stop_statistics_from_decodes

    ckpt = args.run_dir
    if not os.path.exists(os.path.join(ckpt, "config.json")):
        ckpt = os.path.join(ckpt, "ckpt")
    overrides = "stop_threshold=0"   # full-budget decodes while measuring
    if args.hparams:
        overrides += "," + args.hparams
    synth = Synthesizer.from_checkpoint(ckpt, overrides=overrides,
                                        device=args.device)
    hop = stft_params(synth.cfg)[1]
    speakers = ([int(s) for s in args.speakers.split(",")]
                if args.speakers else [-1])
    mels, bounds = [], []
    for text in args.text or DEFAULT_TEXTS:
        for spk in speakers:
            wav, mel, _ = synth.synthesize(text, speaker_id=spk,
                                           want_features="mel")
            mels.append(mel)                  # the full decode, untrimmed
            bounds.append(len(wav) // hop)    # the wav is endpoint-trimmed
    r = int(synth.cfg.outputs_per_step)
    stats = stop_statistics_from_decodes(mels, bounds, r=r)
    stats["r"] = r
    stats["source"] = "decodes"
    return stats


def from_corpus(args, parser) -> dict:
    from nspeech_tpu_torch import config
    from nspeech_tpu_torch.data.corpus import load_items
    from nspeech_tpu_torch.data.features import process_utterance
    from nspeech_tpu_torch.train.metadata import config_from_checkpoint
    from nspeech_tpu_torch.train.stopcal import stop_statistics

    if args.from_run:
        cfg, _model = config_from_checkpoint(args.from_run)
    else:
        cfg = config.load_config("taco2")
    if args.hparams:
        cfg = cfg.parse(args.hparams)
    inputs = {k: getattr(args, k) for k in
              ("ljspeech", "vctk", "librispeech", "arctic") if getattr(args, k)}
    if not inputs:
        parser.error("need a corpus (--ljspeech/--vctk/--librispeech/--arctic)")
    items = load_items(inputs)[: args.max_utts]
    mels = (process_utterance(wav_path, cfg, args.cache_dir).mel
            for wav_path, _text, _spk, _ds in items)
    stats = stop_statistics(mels, r=int(cfg.outputs_per_step), tail=args.tail)
    stats["r"] = int(cfg.outputs_per_step)
    return stats


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    stats = from_decodes(args) if args.run_dir else from_corpus(args, parser)
    _report(stats, args.apply)
    return 0


if __name__ == "__main__":
    sys.exit(main())
