"""Export a trained checkpoint as a self-contained serving artifact.

    python -m nspeech_tpu_torch.cli.export_serving --checkpoint CKPT_DIR \
        --out ARTIFACT_DIR [--text-len 64] [--batch 1] [--platforms cpu,cuda] \
        [--vocoder-checkpoint VOC_DIR --vocoder-frames N --temperature T]

Port of the JAX package's ``export_serving.py`` on the port's serving
checkpoints (``serving/<step>.npz``): the whole text -> waveform program
(decode, Griffin-Lim, weights inside) becomes a ``torch.export`` artifact
(``serving/export.py``), traced on ``--device`` (``cuda`` unless
``cpu``); ``--platforms cpu,cuda`` lets it load on both. With
``--vocoder-checkpoint`` the mel -> waveform program goes into the same
directory, its sampler the CUDA kernel on the card. Serve an artifact
with ``python -m nspeech_tpu_torch.cli.demo_server --artifact DIR``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", required=True,
                        help="Checkpoint dir (config.json + serving/; the run "
                        "metadata supplies the model and hparams)")
    parser.add_argument("--model", default=None,
                        help="Model name (default: from run metadata)")
    parser.add_argument("--hparams", default="",
                        help="k=v,... overrides applied last")
    parser.add_argument("--out", required=True, help="Artifact directory")
    parser.add_argument("--text-len", type=int, default=64,
                        help="Static text length of the program (requests "
                        "pad to it)")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--platforms", default=None,
                        help="Comma-separated devices the artifact may load "
                        "on, e.g. cpu,cuda (default: --device)")
    parser.add_argument("--step", type=int, default=None,
                        help="Checkpoint step (default latest)")
    parser.add_argument("--device", default="cuda",
                        help="Device to trace on: cuda or cpu")
    parser.add_argument("--vocoder-checkpoint", default=None,
                        help="Also export a mel -> waveform WaveNet program "
                        "into the same artifact dir")
    parser.add_argument("--vocoder-hparams", default="")
    parser.add_argument("--vocoder-frames", type=int, default=None,
                        help="Static mel length of the vocoder program "
                        "(default: the acoustic model's max output, "
                        "max_iters * outputs_per_step)")
    parser.add_argument("--temperature", type=float, default=1.0,
                        help="Vocoder sampling temperature (fixed at export)")
    args = parser.parse_args(argv)

    from nspeech_tpu_torch.serving import Synthesizer, WaveNetVocoder
    from nspeech_tpu_torch.serving.export import (MODULE_FILE, VOC_MODULE_FILE,
                                                  export_synthesizer,
                                                  export_vocoder)

    synth = Synthesizer.from_checkpoint(
        args.checkpoint, args.model, overrides=args.hparams, step=args.step,
        text_bucket=args.text_len, device=args.device)
    platforms = (tuple(p.strip() for p in args.platforms.split(","))
                 if args.platforms else None)
    out = export_synthesizer(synth, args.out, text_len=args.text_len,
                             batch=args.batch, platforms=platforms)
    size = os.path.getsize(os.path.join(out, MODULE_FILE)) / 1e6
    print("Exported %s -> %s (%.1f MB, platforms=%s, batch=%d, text_len=%d)"
          % (args.checkpoint, out, size, platforms or args.device, args.batch,
             args.text_len))

    if args.vocoder_checkpoint:
        vocoder = WaveNetVocoder.from_checkpoint(
            args.vocoder_checkpoint, overrides=args.vocoder_hparams,
            device=args.device)
        frames = args.vocoder_frames or (
            synth.cfg.max_iters * synth.cfg.outputs_per_step)
        export_vocoder(vocoder, out, frames=frames, batch=args.batch,
                       temperature=args.temperature, platforms=platforms)
        vsize = os.path.getsize(os.path.join(out, VOC_MODULE_FILE)) / 1e6
        print("Exported vocoder %s -> %s (%.1f MB, frames=%d, temperature=%g)"
              % (args.vocoder_checkpoint, out, vsize, frames, args.temperature))


if __name__ == "__main__":
    main()
