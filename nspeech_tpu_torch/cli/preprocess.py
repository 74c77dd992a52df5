"""Offline feature preprocessor.

    python -m nspeech_tpu_torch.cli.preprocess --ljspeech CORPUS_DIR \
        --cache-dir CACHE [--model taco2] [--hparams k=v,...] [options]

Port of the JAX package's ``preprocess.py``: walks the configured corpora
(``data/corpus.py`` ``load_items``), featurizes every utterance
(``data/features.py`` ``build_from_paths``: the C++ loader, trim,
spectrograms) and fills the on-disk cache the trainers' feeders read,
one ``.npz`` per utterance under the JAX package's key and layout, so
either package reads the cache the other wrote. Featurization is host
work in the port, as in its feeder: there is no device to choose (JAX's
``--platform`` has no counterpart).
"""

from __future__ import annotations

import argparse
import time

from nspeech_tpu_torch import config
from nspeech_tpu_torch.data.corpus import load_items
from nspeech_tpu_torch.data.features import build_from_paths


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Featurization runs on the host CPU (there is no --platform "
               "or --device): spectrograms are input-pipeline work, as in "
               "the trainers' feeders.")
    parser.add_argument("--ljspeech", default="")
    parser.add_argument("--vctk", default="")
    parser.add_argument("--librispeech", default="")
    parser.add_argument("--model", default="taco1",
                        help="Model whose audio hparams to use")
    parser.add_argument("--hparams", default="")
    parser.add_argument("--cache-dir", required=True)
    parser.add_argument("--num-workers", type=int, default=1,
                        help="Featurizing processes (each on one CPU thread)")
    parser.add_argument("--limit", type=int, default=0)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config.load_config(args.model)
    cfg.parse(args.hparams)

    input_paths = {}
    if args.ljspeech:
        input_paths["ljspeech"] = args.ljspeech
    if args.vctk:
        input_paths["vctk"] = args.vctk
    if args.librispeech:
        input_paths["librispeech"] = args.librispeech
    items = load_items(input_paths)
    if args.limit:
        items = items[: args.limit]
    print("Processing %d utterances -> %s" % (len(items), args.cache_dir))

    start = time.time()
    wav_paths = [wav_path for wav_path, _text, _spk, _ds in items]
    utts = build_from_paths(wav_paths, cfg, args.cache_dir,
                            num_workers=args.num_workers)
    total_frames = sum(u.n_frames for u in utts)
    total_samples = sum(len(u.wav) for u in utts)
    elapsed = time.time() - start
    print("Done: %d utterances, %d frames, %.1f audio-hours in %.1fs"
          % (len(items), total_frames,
             total_samples / cfg.sample_rate / 3600, elapsed))


if __name__ == "__main__":
    main()
