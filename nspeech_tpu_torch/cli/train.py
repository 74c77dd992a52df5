"""Tacotron trainer.

    python -m nspeech_tpu_torch.cli.train --ljspeech CORPUS_DIR \
        [--model taco2] [--hparams k=v,...] [options]

Port of the JAX package's ``train.py`` for Tacotron-1 and Tacotron-2 on one
device (``cuda`` by default, ``--device cpu`` on the host): the corpus
through the feeder (featurized on the host CPU, optionally cached), the
train step of ``train/loop.py``, checkpoints under ``<log-dir>/<name>/ckpt``
that resume (``train/<step>.pt``) and serve (``serving/<step>.npz`` and
``config.json`` with the speaker map, which ``cli.synthesize`` reads),
``metrics.jsonl``, and at each checkpoint a Griffin-Lim wav and -align,
-wav, -lin and -mel PNGs of the longest utterance of the first batch.
``--device-cache N`` holds N epochs' batches on the device
(``data/device_cache.py``). ``--hparams compute_dtype=bfloat16`` trains
under the bf16 compute policy (``ops/policy.py``: float32 masters, bf16
forward) and ``--matmul-precision`` sets the card's float32 products.
``--git`` refuses a working tree with uncommitted changes and logs the
short hash of HEAD.
WaveNet trains with ``nspeech_tpu_torch.cli.train_wavenet``.

Data-parallel across cards: start one process per card with ``torchrun``::

    torchrun --nproc_per_node 4 -m nspeech_tpu_torch.cli.train --ljspeech DIR ...

Each rank trains on ``cuda:LOCAL_RANK`` (gloo on ``--device cpu``), its
feeder reads the shard ``rank::W`` of the corpus and builds
``batch_size / W`` rows, the ranks pad a step's batches to one shape (one
MAX all-reduce), and the step is the data-parallel one of
``train/loop.py``: the plain step's result on the global batch. Rank 0
alone writes the run directory. A ``batch_size`` that does not divide by
W exits.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from nspeech_tpu_torch import config
from nspeech_tpu_torch import dsp
from nspeech_tpu_torch.data.device_cache import DeviceCachedBatches
from nspeech_tpu_torch.data.feeder import DataFeeder, pad_batch
from nspeech_tpu_torch.dsp.wavio import save_wav
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.ops import policy
from nspeech_tpu_torch.parallel.collectives import max_over_ranks
from nspeech_tpu_torch.parallel.mesh import distributed_env
from nspeech_tpu_torch.text import sequence_to_text, text_to_sequence
from nspeech_tpu_torch.text.cmudict import CMUDict
from nspeech_tpu_torch.train.checkpoint import CheckpointManager
from nspeech_tpu_torch.train.loop import (batch_to_device,
                                          build_tacotron_train_step,
                                          create_state)
from nspeech_tpu_torch.train.metadata import (config_from_checkpoint,
                                              save_run_metadata)
from nspeech_tpu_torch.train.optim import make_optimizer
from nspeech_tpu_torch.train.runner import pick_mesh, run_training
from nspeech_tpu_torch.utils import get_git_commit, infolog, plot, time_string
from nspeech_tpu_torch.utils.infolog import log

TRAINABLE = ("taco1", "taco2")


def prepare_input_paths(args) -> dict:
    input_paths = {}
    if args.vctk:
        input_paths["vctk"] = args.vctk
    if args.ljspeech:
        input_paths["ljspeech"] = args.ljspeech
    if args.librispeech:
        input_paths["librispeech"] = args.librispeech
    if args.arctic:
        input_paths["arctic"] = args.arctic
    return input_paths


def check_supported(args, cfg) -> torch.device:
    """The training device; exits for what this trainer cannot train."""
    if args.model not in TRAINABLE:
        raise SystemExit(f"--model {args.model}: this trainer trains "
                         f"{TRAINABLE}; train a WaveNet with python -m "
                         "nspeech_tpu_torch.cli.train_wavenet")
    return training_device(args, cfg)


def training_device(args, cfg) -> torch.device:
    """The device of both trainers; exits for a compute dtype that is not a
    float, for a missing card and for several cards without ``torchrun``
    (which one?). Under ``torchrun`` a rank's card is
    ``cuda:LOCAL_RANK``."""
    try:
        policy.compute_dtype(cfg)
    except ValueError as e:
        raise SystemExit(str(e))
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                             "to train on the host)")
        if distributed_env():
            return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        if device.index is None and torch.cuda.device_count() > 1:
            raise SystemExit(
                f"--device cuda on a host with {torch.cuda.device_count()} "
                "cards: pass --device cuda:N to train on one, or start one "
                "process per card with torchrun to train data-parallel")
    return device


def start_run(args, cfg, device: torch.device, run_name: str):
    """``(log_dir, dp)``: the data-parallel group (``train/runner.py``
    ``pick_mesh``: None without ``torchrun``), the run directory, and the
    log (``train.log`` on rank 0; the other ranks log nothing)."""
    dp = pick_mesh(cfg.batch_size, device)
    log_dir = os.path.join(args.log_dir, run_name)
    lead = dp is None or dp.rank == 0
    if lead:
        os.makedirs(log_dir, exist_ok=True)
    infolog.init(os.path.join(log_dir, "train.log") if lead else None,
                 run_name, args.slack_url, quiet=not lead)
    if dp is not None:
        log("Data-parallel over %d ranks (%s backend): %d of the batch's %d "
            "rows per rank" % (dp.world, torch.distributed.get_backend(),
                               cfg.batch_size // dp.world, cfg.batch_size))
    return log_dir, dp


def rank_config(cfg, dp):
    """The feeder's config on a rank: ``batch_size / W`` rows."""
    if dp is None:
        return cfg
    return config.Config(dict(cfg.values(), batch_size=cfg.batch_size // dp.world))


def common_shape(batches, dp):
    """Feeder batches padded to the largest text and frame lengths of the
    ranks' batches of each step (one MAX all-reduce per step)."""
    try:
        for b in batches:
            yield pad_batch(b, *max_over_ranks(
                [b.inputs.shape[1], b.mel_targets.shape[1]], dp))
    finally:
        batches.close()


def add_matmul_precision(parser) -> None:
    """``--matmul-precision``, the JAX trainers' flag, on both trainers."""
    parser.add_argument("--matmul-precision", default="highest",
                        choices=list(policy.MATMUL_PRECISIONS),
                        help="Products of float32 tensors on the card: 'highest' "
                             "(float32, TF32 off; the default), "
                             "'tensorfloat32' (TF32 matmuls and cuDNN), "
                             "'bfloat16' (PyTorch's 'medium' float32 matmul "
                             "precision, which runs TF32 on the H100). No "
                             "effect on the CPU. bf16 compute is "
                             "--hparams compute_dtype=bfloat16")


def set_precision(args, cfg, device: torch.device) -> None:
    """Apply ``--matmul-precision`` on the card and log it with the compute
    dtype, as the JAX trainers log theirs."""
    if device.type == "cuda":
        policy.set_matmul_precision(args.matmul_precision)
    log("matmul precision: %s (%s; pass --matmul-precision highest for "
        "float32 products with TF32 off, the port's default), compute dtype "
        "%s" % (args.matmul_precision,
                "on the card" if device.type == "cuda" else "no effect on the CPU",
                cfg.compute_dtype))


def train(log_dir: str, args, cfg, device: torch.device, dp=None) -> None:
    ckpt_dir = os.path.join(log_dir, "ckpt")
    log("Checkpoint dir: %s" % ckpt_dir)
    log("Using model: %s on %s" % (args.model, device))
    log(config.debug_string(cfg))
    set_precision(args, cfg, device)
    if device.type == "cuda":
        # the feeder's thread featurizes on the host: leave a core to the
        # thread that drives the card (the cores shared by the ranks)
        ranks = dp.world if dp is not None else 1
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // ranks - 1))

    cmudict = None
    if cfg.use_cmudict and args.cmudict_path:
        cmudict = CMUDict(args.cmudict_path, keep_ambiguous=False)
        log("Loaded CMUDict with %d unambiguous entries" % len(cmudict))

    lead = dp is None or dp.rank == 0
    feeder = DataFeeder(prepare_input_paths(args), rank_config(cfg, dp),
                        cache_dir=args.cache_dir, seed=args.seed,
                        cmudict=cmudict, holdout=args.holdout,
                        shard_index=dp.rank if dp else 0,
                        shard_count=dp.world if dp else 1)
    cfg.num_speakers = feeder.num_speakers  # startup mutation contract
    log("Loaded %d examples / %d speakers%s" % (
        len(feeder._items), feeder.num_speakers,
        " (+%d held out)" % args.holdout if args.holdout else ""))
    if lead:
        # the EFFECTIVE config (after the mutation) and the speaker map
        # beside the checkpoints, so serving needs no flag hand-off
        save_run_metadata(ckpt_dir, args.model, cfg,
                          speaker_map=feeder.speaker2id)

    model = create_model(args.model, cfg)
    optimizer, schedule = make_optimizer(cfg, args.model)
    ema = float(cfg.ema_decay)
    step_fn = build_tacotron_train_step(model, optimizer, schedule=schedule,
                                        ema_decay=ema, dp=dp)
    state = create_state(model, optimizer, args.seed, ema=bool(ema),
                         device=device)
    ckpt = CheckpointManager(ckpt_dir, args.model, cfg,
                             speaker_map=feeder.speaker2id)

    if args.device_cache:
        cache = DeviceCachedBatches(feeder, device,
                                    n_epoch_variants=args.device_cache,
                                    seed=args.seed, dp=dp)
        log("Device-cached %d batches (%.0f MB on %s); per-step host "
            "transfer eliminated" % (cache.n_batches, cache.cached_mb, device))
        batches = cache.batches()
    elif dp is not None:
        batches = common_shape(feeder.batches(), dp)
    else:
        batches = feeder.batches()
    preview = [None]  # the first batch, for the artifacts

    def wrapped_batches():
        for b in batches:
            if preview[0] is None:
                preview[0] = b
            yield b

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    def griffin_lim(linear):
        wav = dsp.inv_preemphasis(
            dsp.inv_spectrogram(linear, cfg,
                                generator=torch.Generator(device).manual_seed(0)),
            cfg.preemphasis)
        return wav.cpu().numpy()

    @torch.no_grad()
    def artifact_fn(state, step, writer=None):
        b = preview[0]
        if b is None:
            return
        # the LONGEST utterance of the preview batch shows the most
        # alignment structure
        i = int(np.argmax(host(b.input_lengths)))
        data = batch_to_device(b, device)
        row = slice(i, i + 1)
        outputs, _ = model.forward_train(
            state.params, state.bn_state, data.inputs[row],
            data.input_lengths[row], data.speaker_ids[row],
            data.mel_targets[row], is_training=False)
        # in float32 whatever the compute dtype (Griffin-Lim, numpy)
        lin = policy.upcast(outputs["linear_outputs"][0])
        wav = griffin_lim(lin)
        wav = wav[: dsp.find_endpoint(wav, cfg)]
        lin = lin.cpu().numpy()
        mel = policy.upcast(outputs["mel_outputs"][0]).cpu().numpy()
        align = policy.upcast(outputs["alignments"][0]).cpu().numpy()
        base = os.path.join(log_dir, "step-%06d" % step)
        save_wav(wav, base + "-audio.wav", cfg.sample_rate)
        text = sequence_to_text(host(b.inputs[i]))
        # crop padding off the alignment: the real input length, and the
        # decoder steps up to the last voiced target frame
        t_in = int(b.input_lengths[i])
        voiced = np.flatnonzero(np.abs(host(b.mel_targets[i])).sum(-1))
        last_frame = int(voiced[-1]) + 1 if len(voiced) else 0
        s_used = -(-last_frame // cfg.outputs_per_step)
        # teacher-forced, like the reference's training dumps
        plot.plot_alignment(align[:t_in, :s_used + 2], base + "-align.png",
                            info="%s, %s, step=%d (teacher-forced)"
                                 % (args.model, time_string(), step))
        plot.plot_wave(wav, cfg.sample_rate, base + "-wav.png", text)
        plot.plot_specgram(lin, base + "-lin.png", "linear")
        plot.plot_specgram(mel, base + "-mel.png", "mel")
        if writer is not None:
            writer.histograms(step, {"linear_outputs": lin,
                                     "mel_outputs": mel})
        log("Dumped artifacts for step %d (input: %s)" % (step, text))

        if args.freerun_preview:
            # the AUTOREGRESSIVE decode (the serving path): surfaces a model
            # that free-runs to silence while its teacher-forced preview
            # looks fine
            if args.freerun_text:
                seq = text_to_sequence(
                    args.freerun_text,
                    [c.strip() for c in cfg.cleaners.split(",")])
                fr_ids = torch.tensor([seq], device=device)
                fr_len = torch.tensor([len(seq)], device=device)
                t_in = len(seq)
            else:
                fr_ids, fr_len = data.inputs[row], data.input_lengths[row]
            out = model.forward(state.params, state.bn_state, fr_ids, fr_len,
                                data.speaker_ids[row])
            fr_wav = griffin_lim(policy.upcast(out["linear_outputs"][0]))
            fr_steps = int(out["decoder_steps"][0])
            # UNTRIMMED audio and full-frame RMS: silence must stay audible
            # in the artifact and visible in the metric
            hop = config.stft_params(cfg)[1]
            fr_rms = float(np.sqrt(np.mean(np.square(
                fr_wav[: fr_steps * cfg.outputs_per_step * hop]))))
            save_wav(fr_wav, base + "-freerun.wav", cfg.sample_rate)
            plot.plot_alignment(policy.upcast(out["alignments"][0]).cpu().numpy()[:t_in, :fr_steps],
                                base + "-freerun-align.png")
            if writer is not None:
                writer.scalars(step, {"freerun_rms": fr_rms,
                                      "freerun_decoder_steps": fr_steps})
            log("Free-run preview at step %d: rms=%.04f decoder_steps=%d"
                % (step, fr_rms, fr_steps))

    eval_fn = None
    if args.holdout and lead:
        # teacher-forced loss on utterances training never sees
        eval_batch = batch_to_device(feeder.holdout_batch(), device)

        @torch.no_grad()
        def eval_fn(state, step, writer):
            b = eval_batch
            outputs, _ = model.forward_train(
                state.params, state.bn_state, b.inputs, b.input_lengths,
                b.speaker_ids, b.mel_targets, is_training=False)
            loss, metrics = model.loss(outputs, b.mel_targets, b.linear_targets)
            scalars = {"holdout_" + k: float(v) for k, v in metrics.items()}
            writer.scalars(step, scalars)
            log("Holdout eval at step %d: loss=%.05f (%d utterances)"
                % (step, float(loss), len(feeder.holdout_items)))

    try:
        run_training(
            log_dir, ckpt, state, step_fn, wrapped_batches(), device, args.seed,
            checkpoint_interval=args.checkpoint_interval,
            summary_interval=args.summary_interval,
            log_interval=args.log_every,
            max_steps=args.max_steps,
            artifact_fn=artifact_fn,
            eval_fn=eval_fn,
            restore_step=args.restore_step,
            to_device=batch_to_device,
            dp=dp,
        )
    finally:
        batches.close()   # stops the feeder's prefetch thread


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--log-dir", default="logs")
    parser.add_argument("--vctk", default="")
    parser.add_argument("--ljspeech", default="", help="LJSpeech-layout corpus dir")
    parser.add_argument("--librispeech", default="", help="corpus.csv-layout dir")
    parser.add_argument("--arctic", default="", help="CMU Arctic corpus dir")
    parser.add_argument("--model", default=None,
                        help="taco1 or taco2 (default: taco1, or the "
                             "--hparams-from checkpoint's model)")
    parser.add_argument("--name", help="Run name (defaults to model name)")
    parser.add_argument("--hparams", default="",
                        help="Comma-separated name=value overrides")
    parser.add_argument("--hparams-from", default="", metavar="CKPT_DIR",
                        help="Fine-tuning base: the effective hparams (and "
                             "model name) of a checkpoint dir's config.json "
                             "in place of the defaults; --hparams applies "
                             "on top")
    parser.add_argument("--restore-step", type=int,
                        help="Checkpoint step to restore (default: latest)")
    parser.add_argument("--summary-interval", type=int, default=1000)
    parser.add_argument("--log-every", type=int, default=1,
                        help="Read the loss (a device sync) only every N-th "
                             "step; 1 = a log line per step")
    parser.add_argument("--checkpoint-interval", type=int, default=1000)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--slack-url", help="Slack webhook for run reports")
    parser.add_argument("--cache-dir", default=None,
                        help="On-disk feature cache directory")
    parser.add_argument("--device-cache", type=int, default=0, metavar="N",
                        help="Hold N epochs' batches on the device, padded "
                             "to one shape, their order reshuffled each "
                             "epoch (no per-step host transfer)")
    parser.add_argument("--holdout", type=int, default=0, metavar="N",
                        help="Hold N evenly spaced utterances out of training "
                             "and log their teacher-forced loss every "
                             "summary interval")
    parser.add_argument("--freerun-preview", action="store_true",
                        help="At each checkpoint also decode the preview "
                             "utterance autoregressively (-freerun.wav, "
                             "-freerun-align.png, freerun_rms)")
    parser.add_argument("--freerun-text", default="",
                        help="With --freerun-preview: free-run this text "
                             "instead of a training utterance")
    parser.add_argument("--cmudict-path", default=None,
                        help="cmudict-0.7b file for ARPAbet substitution")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (one card; under torchrun the rank's "
                             "card) or cpu")
    add_matmul_precision(parser)
    parser.add_argument("--git", action="store_true",
                        help="Verify the working tree is clean")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.hparams_from:
        cfg, args.model = config_from_checkpoint(
            args.hparams_from, model_name=args.model, overrides=args.hparams)
    else:
        args.model = args.model or "taco1"
        cfg = config.load_config(args.model)
        cfg.parse(args.hparams)
    device = check_supported(args, cfg)
    log_dir, dp = start_run(args, cfg, device, args.name or args.model)
    try:
        if args.hparams_from:
            log("hparams base: run metadata from %s" % args.hparams_from)
        if args.git:
            get_git_commit()
        train(log_dir, args, cfg, device, dp)
    finally:
        if dp is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
