"""End-to-end text -> waveform from checkpoints.

    python -m nspeech_tpu_torch.cli.synthesize --checkpoint CKPT_DIR \
        --text "..." [--vocoder-checkpoint VOC_DIR] [options]

Port of the JAX package's ``synthesize.py``, on the port's serving
checkpoints (``train/checkpoint.py``): Tacotron-2 mels, then the
mel-conditioned WaveNet vocoder (the CUDA sampler on ``--device cuda``,
the default; the plain generator on ``cpu``), or Griffin-Lim without a
vocoder checkpoint.
"""

from __future__ import annotations

import argparse

from nspeech_tpu_torch.dsp.wavio import save_wav
from nspeech_tpu_torch.serving import Synthesizer, TextToSpeech, WaveNetVocoder
from nspeech_tpu_torch.serving.errors import ClientError, check_ids


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", required=True,
                        help="Acoustic-model checkpoint dir")
    parser.add_argument("--model", default=None,
                        help="Model name (default: checkpoint run metadata)")
    parser.add_argument("--hparams", default="")
    parser.add_argument("--vocoder-checkpoint", default=None,
                        help="WaveNet vocoder checkpoint dir (else Griffin-Lim)")
    parser.add_argument("--vocoder-model", default=None)
    parser.add_argument("--vocoder-hparams", default="")
    parser.add_argument("--text", required=True)
    parser.add_argument("--speaker", type=int, default=-1)
    parser.add_argument("--num-speakers", type=int, default=None)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--out", default="synth.wav")
    parser.add_argument("--long", action="store_true",
                        help="Long-form mode (not ported yet: ROADMAP.md "
                             "section 1, item 10)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard batched synthesis over devices (not "
                             "ported yet: ROADMAP.md section 1, item 15)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the sampler kernel) or cpu (plain)")
    args = parser.parse_args(argv)
    if args.long:
        raise SystemExit("--long needs serving/longform.py, not ported yet "
                         "(ROADMAP.md section 1, item 10)")
    if args.data_parallel:
        raise SystemExit("--data-parallel needs multi-GPU serving, not "
                         "ported yet (ROADMAP.md section 1, item 15)")

    # The run metadata next to the checkpoint supplies the training-time
    # hparams (incl. the mutated num_speakers); --hparams and
    # --num-speakers still override.
    overrides = args.hparams
    if args.num_speakers is not None:
        overrides = (overrides + "," if overrides else "") \
            + "num_speakers=%d" % args.num_speakers
    synth = Synthesizer.from_checkpoint(args.checkpoint, args.model,
                                        overrides, device=args.device)
    cfg = synth.cfg
    vocoder = None
    if args.vocoder_checkpoint:
        vocoder = WaveNetVocoder.from_checkpoint(
            args.vocoder_checkpoint, args.vocoder_model,
            args.vocoder_hparams, device=args.device)
    tts = TextToSpeech(synth, vocoder)
    # --speaker indexes the speaker table and, with a vocoder, its gc
    # table: checked before any launch (on the card an id past a table is
    # a device-side assert; the JAX CLI synthesizes from NaN rows)
    try:
        synth.check_speakers([args.speaker])
        if vocoder is not None and vocoder.net.gc_channels and args.speaker >= 0:
            check_ids([args.speaker], vocoder.net.gc_cardinality, "gc id")
    except ClientError as e:
        raise SystemExit(f"--speaker: {e}") from None
    wav, _mel, _lin = tts.synthesize(args.text, args.speaker,
                                     temperature=args.temperature)
    save_wav(wav, args.out, cfg.sample_rate)
    print("Wrote %s (%.2fs of audio, vocoder=%s)" % (
        args.out, len(wav) / cfg.sample_rate,
        "wavenet" if vocoder else "griffin-lim"))


if __name__ == "__main__":
    main()
