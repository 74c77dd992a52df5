"""WaveNet vocoder trainer.

    python -m nspeech_tpu_torch.cli.train_wavenet --ljspeech CORPUS_DIR \\
        [--hparams k=v,...] [--gta-dir DIR] [options]

Port of the JAX package's ``train_wavenet.py`` on one device (``cuda`` by
default, ``--device cpu`` on the host): windows of receptive field +
``sample_size`` samples from ``data/wavenet_feeder.py`` (computed mels, or
with ``--gta-dir`` the teacher-forced mels of ``cli.export_gta``), the
WaveNet train step of ``train/loop.py``, and checkpoints under
``<log-dir>/<name>/ckpt`` that resume (``train/<step>.pt``) and serve
(``serving/<step>.npz`` and ``config.json`` with the speaker map, which
``cli.generate_wavenet`` and ``cli.synthesize --vocoder-checkpoint``
read). The start-up mutations are the JAX trainer's: ``num_speakers`` and
``gc_category_cardinality`` from the feeder, an L2 strength of 0 as none.
"""

from __future__ import annotations

import argparse
import os

import torch

from nspeech_tpu_torch import config
from nspeech_tpu_torch.cli.train import (add_matmul_precision,
                                         prepare_input_paths, set_precision,
                                         training_device)
from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.train.checkpoint import CheckpointManager
from nspeech_tpu_torch.train.loop import (build_wavenet_train_step,
                                          create_state, wavenet_batch_to_device)
from nspeech_tpu_torch.train.metadata import (config_from_checkpoint,
                                              save_run_metadata)
from nspeech_tpu_torch.train.optim import make_optimizer
from nspeech_tpu_torch.train.runner import run_training
from nspeech_tpu_torch.utils import infolog
from nspeech_tpu_torch.utils.infolog import log

TRAINABLE = ("wavenet", "simple_wavenet")


def check_supported(args, cfg) -> torch.device:
    """The training device; exits for what this trainer cannot train."""
    if args.model not in TRAINABLE:
        raise SystemExit(f"--model {args.model}: this trainer trains "
                         f"{TRAINABLE}; train a Tacotron with python -m "
                         "nspeech_tpu_torch.cli.train")
    return training_device(args, cfg)


def train_wavenet(log_dir: str, args, cfg, device: torch.device) -> None:
    ckpt_dir = os.path.join(log_dir, "ckpt")
    log("Checkpoint dir: %s" % ckpt_dir)
    log("Using model: %s on %s" % (args.model, device))
    log(config.debug_string(cfg))
    set_precision(args, cfg, device)

    # the model first: the feeder needs the receptive field
    net = create_model(args.model, cfg)
    log("Receptive field: %d samples" % net.receptive_field)
    if args.gta_dir:
        if cfg.lc_channels <= 0:
            raise SystemExit(
                "--gta-dir is local conditioning data; it requires "
                "lc_channels > 0 (e.g. --hparams lc_channels=%d)" % cfg.num_mels)
        log("GTA mode: local conditioning from predicted mels in %s"
            % args.gta_dir)
    feeder = WaveNetFeeder(prepare_input_paths(args), net.receptive_field, cfg,
                           seed=args.seed, gta_dir=args.gta_dir or None)
    cfg.num_speakers = feeder.num_speakers
    cfg.gc_category_cardinality = feeder.num_speakers
    l2 = cfg.l2_regularization_strength or None
    # the EFFECTIVE config (after the mutations) and the speaker map beside
    # the checkpoints, so generation needs no flag hand-off
    save_run_metadata(ckpt_dir, args.model, cfg, speaker_map=feeder.speaker2id)

    use_gc = cfg.gc_channels > 0
    use_lc = cfg.lc_channels > 0
    if use_gc:
        net = create_model(args.model, cfg)   # with the feeder's cardinality

    optimizer, schedule = make_optimizer(cfg, args.model)
    ema = float(cfg.ema_decay)
    step_fn = build_wavenet_train_step(net, optimizer, cfg, schedule=schedule,
                                       use_gc=use_gc, use_lc=use_lc,
                                       l2_strength=l2, ema_decay=ema)
    state = create_state(net, optimizer, args.seed, ema=bool(ema), device=device)
    ckpt = CheckpointManager(ckpt_dir, args.model, cfg,
                             speaker_map=feeder.speaker2id)
    run_training(
        log_dir, ckpt, state, step_fn, feeder.batches(), device, args.seed,
        checkpoint_interval=args.checkpoint_interval,
        summary_interval=args.summary_interval,
        log_interval=args.log_every,
        max_steps=args.max_steps,
        restore_step=args.restore_step,
        to_device=wavenet_batch_to_device,
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--log-dir", default="logs")
    parser.add_argument("--vctk", default="")
    parser.add_argument("--ljspeech", default="")
    parser.add_argument("--librispeech", default="")
    parser.add_argument("--arctic", default="")
    parser.add_argument("--model", default=None,
                        help="Model name (default: wavenet, or the "
                             "--hparams-from checkpoint's model)")
    parser.add_argument("--name", help="Run name (defaults to model name)")
    parser.add_argument("--hparams", default="",
                        help="Comma-separated name=value overrides")
    parser.add_argument("--hparams-from", default="", metavar="CKPT_DIR",
                        help="Fine-tuning base: the effective hparams (and "
                             "model name) of a checkpoint dir's config.json "
                             "in place of the defaults; --hparams applies on "
                             "top (e.g. a trained vocoder on --gta-dir mels)")
    parser.add_argument("--restore-step", type=int)
    parser.add_argument("--summary-interval", type=int, default=1000)
    parser.add_argument("--log-every", type=int, default=1,
                        help="Read the loss (a device sync) only every N-th "
                             "step; 1 = a log line per step")
    parser.add_argument("--checkpoint-interval", type=int, default=1000)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--slack-url")
    parser.add_argument("--cache-dir", default=None,
                        help="Accepted for the JAX trainer's flags; the window "
                             "feeder featurizes each utterance as it visits "
                             "it and caches nothing, as the JAX one")
    parser.add_argument("--gta-dir", default="",
                        help="Train on the ground-truth-aligned mels that "
                             "cli.export_gta wrote instead of computed mels")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (one card) or cpu")
    add_matmul_precision(parser)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.hparams_from:
        cfg, args.model = config_from_checkpoint(
            args.hparams_from, model_name=args.model, overrides=args.hparams)
    else:
        args.model = args.model or "wavenet"
        cfg = config.load_config(args.model)
        cfg.parse(args.hparams)
    device = check_supported(args, cfg)
    run_name = args.name or args.model
    log_dir = os.path.join(args.log_dir, run_name)
    os.makedirs(log_dir, exist_ok=True)
    infolog.init(os.path.join(log_dir, "train.log"), run_name, args.slack_url)
    if args.hparams_from:
        log("hparams base: run metadata from %s" % args.hparams_from)
    train_wavenet(log_dir, args, cfg, device)


if __name__ == "__main__":
    main()
