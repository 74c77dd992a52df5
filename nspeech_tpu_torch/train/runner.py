"""The training loop: port of ``nspeech_tpu/train/runner.py``.

Auto-resume from the latest checkpoint (or ``restore_step``), a log line
per step with sec/step and 100-step averages, the explosion guard (a loss
above 100 or NaN restores the last checkpoint, up to ``max_recoveries``
times, then aborts), metric summaries, checkpoints, and artifact and
holdout-eval hooks whose failures are logged and do not stop training.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterator, Optional

from nspeech_tpu_torch.train.checkpoint import CheckpointManager
import torch

from nspeech_tpu_torch.train.loop import TrainState, step_generator
from nspeech_tpu_torch.utils import ValueWindow
from nspeech_tpu_torch.utils.infolog import log
from nspeech_tpu_torch.utils.metrics import MetricWriter


def run_training(
    log_dir: str,
    ckpt: CheckpointManager,
    state: TrainState,
    step_fn: Callable,
    batches: Iterator,
    device,
    seed: int,
    checkpoint_interval: int = 1000,
    summary_interval: int = 1000,
    max_steps: Optional[int] = None,
    artifact_fn: Optional[Callable] = None,
    eval_fn: Optional[Callable] = None,
    restore_step: Optional[int] = None,
    max_recoveries: int = 3,
    log_interval: int = 1,
    *,
    to_device: Callable,
) -> TrainState:
    """Run ``step_fn`` over ``batches`` until ``max_steps`` (or forever);
    returns the last state. ``to_device(batch, device)`` gives a batch as
    ``step_fn`` takes it (``train/loop.py`` ``batch_to_device`` for a
    Tacotron feeder's, ``wavenet_batch_to_device`` for WaveNet windows).

    ``artifact_fn(state, step, writer)`` runs at every checkpoint and
    ``eval_fn(state, step, writer)`` at every summary interval. With
    ``log_interval`` > 1 the loss (a device sync) is read only every N-th
    step and at summaries, checkpoints and the last step; the explosion
    guard then fires at the next read."""
    if restore_step is not None or ckpt.latest_step() is not None:
        state = ckpt.restore(state, step=restore_step, device=device)
        log(f"Resumed from checkpoint step {int(state.step)}", slack=True)
    else:
        log("Starting new training run", slack=True)

    writer = MetricWriter(log_dir)
    time_window, loss_window = ValueWindow(100), ValueWindow(100)
    recoveries = 0
    step = int(state.step)
    try:
        for batch in batches:
            if max_steps is not None and step >= max_steps:
                break
            start = time.time()
            data = to_device(batch, device)
            state, metrics = step_fn(state, data,
                                     step_generator(device, seed, step))
            step += 1
            synced = (log_interval <= 1 or step % log_interval == 0
                      or step % summary_interval == 0
                      or step % checkpoint_interval == 0
                      or (max_steps is not None and step >= max_steps))
            if not synced:
                time_window.append(time.time() - start)
                continue
            loss = float(metrics["loss"])  # device sync point
            time_window.append(time.time() - start)
            loss_window.append(loss)
            log("Step %-7d [%.03f sec/step, loss=%.05f, avg_loss=%.05f]" % (
                step, time_window.average, loss, loss_window.average),
                slack=(step % checkpoint_interval == 0))

            if loss > 100 or math.isnan(loss):
                log("Loss exploded to %.05f at step %d!" % (loss, step),
                    slack=True)
                if recoveries < max_recoveries and ckpt.latest_step() is not None:
                    recoveries += 1
                    state = ckpt.restore(state, device=device)
                    step = int(state.step)
                    loss_window.reset()
                    log("Auto-restored from checkpoint step %d "
                        "(recovery %d/%d)" % (step, recoveries,
                                              max_recoveries), slack=True)
                    continue
                raise RuntimeError("Loss exploded")

            if step % summary_interval == 0 and eval_fn is not None:
                try:
                    eval_fn(state, step, writer)
                except Exception as e:  # the holdout eval must not kill training
                    log("Holdout eval failed: %r" % e)

            if step % summary_interval == 0:
                writer.scalars(step, {k: float(v) for k, v in metrics.items()
                                      if getattr(v, "ndim", 0) == 0})
                hists = {k: v.cpu().numpy() for k, v in metrics.items()
                         if getattr(v, "ndim", 0) > 0}
                for name in ("mel_targets", "linear_targets"):
                    if hasattr(batch, name):  # a Tacotron batch's targets
                        x = getattr(batch, name)
                        hists[name] = (x.cpu().numpy()
                                       if isinstance(x, torch.Tensor) else x)
                if hists:
                    writer.histograms(step, hists)

            if step % checkpoint_interval == 0:
                log("Saving checkpoint at step %d" % step)
                ckpt.save(step, state)
                if artifact_fn is not None:
                    try:
                        artifact_fn(state, step, writer)
                    except Exception as e:  # artifacts must not kill training
                        log("Artifact dump failed: %r" % e)

            if max_steps is not None and step >= max_steps:
                if step % checkpoint_interval != 0:
                    log("Reached max steps (%d); saving final checkpoint" % step)
                    ckpt.save(step, state)
                break
    finally:
        writer.close()
    return state
