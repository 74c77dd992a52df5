"""Export ground-truth-aligned (GTA) mels for vocoder fine-tuning.

    python -m nspeech_tpu_torch.cli.export_gta --checkpoint CKPT_DIR \\
        --ljspeech CORPUS_DIR [--out-dir DIR] [options]

Port of the JAX package's ``export_gta.py``, with ``--device`` (``cuda`` by
default) in place of ``--platform``: runs a trained Tacotron (a serving
checkpoint of ``cli.train``) teacher-forced over a corpus and saves its
predicted mels (``data/gta.py``); then
``python -m nspeech_tpu_torch.cli.train_wavenet --gta-dir <out> --hparams
lc_channels=80`` trains the vocoder on the features it sees in serving.
"""

from __future__ import annotations

import argparse
import os

import torch

from nspeech_tpu_torch.cli.train import prepare_input_paths
from nspeech_tpu_torch.data.gta import export_gta
from nspeech_tpu_torch.ops.policy import set_matmul_precision


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", required=True,
                        help="Acoustic-model checkpoint dir (log_dir/<run>/ckpt)")
    parser.add_argument("--checkpoint-step", type=int, default=None)
    parser.add_argument("--model", default=None,
                        help="Model name (default: checkpoint run metadata)")
    parser.add_argument("--hparams", default="")
    parser.add_argument("--vctk", default="")
    parser.add_argument("--ljspeech", default="")
    parser.add_argument("--librispeech", default="")
    parser.add_argument("--arctic", default="")
    parser.add_argument("--out-dir", default=None,
                        help="GTA output dir (default: <checkpoint>/../gta)")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--text-bucket", type=int, default=32)
    parser.add_argument("--frame-bucket", type=int, default=128,
                        help="Mel-frame padding granularity")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                             "to export on the host)")
        set_matmul_precision("highest")

    out_dir = args.out_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.checkpoint)), "gta")
    manifest = export_gta(
        args.checkpoint, prepare_input_paths(args), out_dir,
        model_name=args.model, overrides=args.hparams,
        step=args.checkpoint_step, batch_size=args.batch_size,
        text_bucket=args.text_bucket, frame_bucket=args.frame_bucket,
        device=device)
    print("Wrote %d GTA mels + manifest to %s" % (manifest["count"], out_dir))


if __name__ == "__main__":
    main()
