"""Batch evaluation: synthesize fixed sentences from a checkpoint.

    python -m nspeech_tpu_torch.cli.eval --checkpoint CKPT_DIR \
        [--vocoder-checkpoint VOC_DIR] [--skip-harvard] [options]

Port of the JAX package's ``eval.py``: 8 news/demo sentences and Harvard
groups 1-3, each written as ``<base>.wav`` with ``<base>-lin.png`` and
``<base>-mel.png`` (spectrogram images, ``utils/plot.py``) into
``--output-dir`` (default: beside the checkpoint). Griffin-Lim, or the
WaveNet vocoder with ``--vocoder-checkpoint`` (the CUDA sampler on
``--device cuda``, the default; the plain generator on ``cpu``).
"""

from __future__ import annotations

import argparse
import os

from nspeech_tpu_torch.dsp.wavio import save_wav
from nspeech_tpu_torch.serving import Synthesizer, TextToSpeech, WaveNetVocoder
from nspeech_tpu_torch.utils import plot

HARVARD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "harvard_sentences.txt")

sentences = [
    "Scientists at the CERN laboratory say they have discovered a new particle.",
    "There's a way to measure the acute emotional intelligence that has never gone out of style.",
    "President Trump met with other leaders at the Group of Twenty conference.",
    "The Senate's bill to repeal and replace the Affordable Care Act is now imperiled.",
    "Generative adversarial network or variational auto-encoder.",
    "The buses aren't the problem, they actually provide a solution.",
    "Does the quick brown fox jump over the lazy dog?",
    "Talib Kweli confirmed to AllHipHop that he will be releasing an album in the next year.",
]


def _synthesize_to(synth, cfg, text: str, path: str, speaker: int) -> None:
    print("Synthesizing: %s" % path)
    wav, mel, lin = synth.synthesize(text, speaker)
    save_wav(wav, path + ".wav", cfg.sample_rate)
    plot.plot_specgram(lin, path + "-lin.png", "linear")
    plot.plot_specgram(mel, path + "-mel.png", "mel")


def simple_eval(args, synth, cfg, base_path: str) -> None:
    for i, text in enumerate(sentences):
        _synthesize_to(synth, cfg, text, "%s-%d" % (base_path, i), args.speaker)


def harvard_eval(args, synth, cfg, base_path: str) -> None:
    with open(HARVARD) as f:
        lines = f.readlines()
    for i, text in enumerate(lines):
        if i % 11 == 0:
            continue  # list headers
        if i / 11 > 3:
            # float division, as the reference selects: exactly Harvard
            # groups 1-3 (30 sentences), since line 33 is group 4's header
            break
        text = " ".join(text.split()[1:])
        out = "%s-h%d-%d" % (base_path, int(i / 11), i % 11)
        _synthesize_to(synth, cfg, text, out, args.speaker)


def run_eval(args, synth) -> None:
    cfg = synth.cfg
    step = args.checkpoint_step if args.checkpoint_step is not None else "latest"
    out_dir = args.output_dir or os.path.dirname(args.checkpoint)
    os.makedirs(out_dir, exist_ok=True)
    base_path = os.path.join(out_dir, "eval-%s" % step)
    simple_eval(args, synth, cfg, base_path)
    if not args.skip_harvard:
        harvard_eval(args, synth, cfg, base_path)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", required=True,
                        help="Checkpoint directory (config.json + serving/)")
    parser.add_argument("--checkpoint-step", type=int, default=None)
    parser.add_argument("--model", default=None,
                        help="Model name (default: checkpoint run metadata)")
    parser.add_argument("--hparams", default="")
    parser.add_argument("--speaker", type=int, default=-1)
    parser.add_argument("--num-speakers", type=int, default=None,
                        help="Speaker count the checkpoint was trained with")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--skip-harvard", action="store_true")
    parser.add_argument("--vocoder-checkpoint", default=None,
                        help="WaveNet vocoder checkpoint dir: eval through "
                        "the full pipeline instead of Griffin-Lim")
    parser.add_argument("--vocoder-model", default=None)
    parser.add_argument("--vocoder-hparams", default="")
    parser.add_argument("--text-bucket", type=int, default=32,
                        help="Pad text lengths up to multiples of this")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the sampler kernel) or cpu (plain)")
    args = parser.parse_args(argv)
    overrides = args.hparams
    if args.num_speakers is not None:
        overrides = (overrides + "," if overrides else "") \
            + "num_speakers=%d" % args.num_speakers
    synth = Synthesizer.from_checkpoint(
        args.checkpoint, args.model, overrides, step=args.checkpoint_step,
        text_bucket=args.text_bucket, device=args.device)
    if args.vocoder_checkpoint:
        vocoder = WaveNetVocoder.from_checkpoint(
            args.vocoder_checkpoint, args.vocoder_model, args.vocoder_hparams,
            device=args.device)
        synth = TextToSpeech(synth, vocoder)
    run_eval(args, synth)


if __name__ == "__main__":
    main()
