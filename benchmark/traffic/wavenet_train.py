"""WaveNet vocoder training: the port's WaveNet train step over its window
feeder, as ``cli.train_wavenet`` configures them, for the whole window.

Set-up writes the training cell's synthetic corpus (``train_loop``'s:
``corpus_clips`` clips of quantile durations, harmonic tones loud
throughout, in LJSpeech's layout under ``TMPDIR``), builds
``WaveNetFeeder`` (frame-rate mels, upsampled on the card),
``make_optimizer(cfg, "wavenet")`` with its Noam schedule,
``build_wavenet_train_step`` with the recipe's local conditioning, L2
strength and EMA decay, and a state from the benchmark's seeded weights,
and runs ``setup_steps`` steps. Every batch has one shape (``batch_size``
windows of the receptive field + ``sample_size`` samples), so every step
after the first is a steady one. Each step is the runner's: the
feeder's next batch (inline: it loads, trims and featurizes each
utterance it visits), the batch to the card, the step, the loss read on
the host. A step trains ``batch_size`` x ``sample_size`` scored samples.

Correctness: the first three steps of set-up against the plain
reference (``reference/wavenet_train.py``): each window's samples found
among the reference's own windows of the same WAVs, its mel rows and
phase against the reference's featurizing (exact), then each step's
loss, the first gradient as Adam got it (its first moment after step 1
over 1 - beta1) and the parameters' change over the three steps, each
by its worst leaf (``train_loop``'s measures)."""

from __future__ import annotations

import atexit
import contextlib
import os
import shutil
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import core, wavenet_flops, weights
from benchmark.harness.core import Compare, Run, now
from benchmark.harness.trace import span
from benchmark.reference import dsp as rdsp
from benchmark.reference import precision
from benchmark.reference import wavenet as rwavenet
from benchmark.reference import wavenet_train as rtrain

SALT = 4
MODEL = "wavenet"
CHECKED_STEPS = 3
TRAIN_LOOP = core.module("traffic", "train_loop")   # its corpus and measures


def _corpus(ctx, root: str):
    """``train_loop``'s corpus at this configuration's sample rate: [(wav
    path, text, samples)]."""
    shim = SimpleNamespace(params=ctx.params, seed=ctx.seed,
                           config={"taco2": ctx.config[MODEL]})
    return TRAIN_LOOP._corpus(shim, root)


def setup(ctx):
    from nspeech_tpu_torch.config import Config
    from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder
    from nspeech_tpu_torch.models import create_model
    from nspeech_tpu_torch.ops.policy import set_matmul_precision
    from nspeech_tpu_torch.train.loop import (TrainState,
                                              build_wavenet_train_step,
                                              wavenet_batch_to_device)
    from nspeech_tpu_torch.train.optim import make_optimizer

    p, c = ctx.params, ctx.config[MODEL]
    root = tempfile.mkdtemp(prefix="nspeech-bench-corpus-")
    atexit.register(shutil.rmtree, root, True)
    items = _corpus(ctx, root)
    device = torch.device(ctx.device)
    if device.type == "cuda":
        set_matmul_precision("highest")
        torch.set_num_threads(max(1, (os.cpu_count() or 2) - 1))
    cfg = Config(dict(c))
    # cli.train_wavenet's order: the model for its receptive field, the
    # feeder, the speaker counts from the feeder, then the step
    net = create_model(MODEL, cfg)
    feeder = WaveNetFeeder({"ljspeech": root}, net.receptive_field, cfg, seed=ctx.seed)
    cfg.num_speakers = feeder.num_speakers
    cfg.gc_category_cardinality = feeder.num_speakers
    optimizer, schedule = make_optimizer(cfg, MODEL)
    ema = float(cfg.ema_decay)
    step_fn = build_wavenet_train_step(
        net, optimizer, cfg, schedule=schedule, use_gc=cfg.gc_channels > 0,
        use_lc=cfg.lc_channels > 0, l2_strength=cfg.l2_regularization_strength or None,
        ema_decay=ema)
    (params,) = weights.make([rwavenet.param_shapes(c)], ctx.seed, SALT, ctx.device)
    state = TrainState(0, params, {}, optimizer.init(params),
                       TRAIN_LOOP._map(torch.clone, params) if ema else None)
    batches = feeder.batches()
    sut = {"items": items, "batches": batches, "state": state,
           "step_fn": step_fn, "to_device": wavenet_batch_to_device, "device": device,
           "checked": [], "losses": []}
    for k in range(int(p["setup_steps"])):
        b = next(batches)
        if k < CHECKED_STEPS:
            sut["checked"].append({f: np.array(getattr(b, f)) for f in b._fields})
        _step(sut, b)
        if k == 0:
            sut["mu1"] = TRAIN_LOOP._host(sut["state"].opt_state["mu"])
        if k == CHECKED_STEPS - 1:
            sut["params3"] = TRAIN_LOOP._host(sut["state"].params)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sut


def _step(sut, b) -> None:
    data = sut["to_device"](b, sut["device"])
    sut["state"], metrics = sut["step_fn"](sut["state"], data)
    sut["losses"].append(float(metrics["loss"]))     # the runner's sync per step


def window(ctx, sut, tracer) -> Run:
    p, c = ctx.params, ctx.config[MODEL]
    records = []
    traced = {}
    trace_from, trace_steps = int(p["trace_after_steps"]), int(p["trace_steps"])
    start = now()
    end = start + ctx.seconds
    while now() < end:
        k = len(records)
        if ctx.trace and k == trace_from:
            tracer.start()
            traced["t0"], traced["step0"] = now(), k
        t0 = now()
        with span("feeder_next", ctx.trace):
            b = next(sut["batches"])
        t1 = now()
        with span("train_step", ctx.trace):
            _step(sut, b)
        t2 = now()
        records.append({"t0": t0, "t_batch": t1, "t1": t2,
                        "frames": [c["sample_size"]] * b.audio.shape[0]})
        if ctx.trace and k + 1 == trace_from + trace_steps:
            tracer.stop()
            traced["t1"], traced["steps"] = now(), trace_steps
    if ctx.trace and "t1" not in traced and "t0" in traced:
        tracer.stop()
        traced["t1"], traced["steps"] = now(), len(records) - traced["step0"]
    return Run(window_s=records[-1]["t1"] - start if records else ctx.seconds,
               records=records, counters={"steps": len(records)},
               info={"traced": traced, "frame_s": 1.0 / c["sample_rate"],
                     "flops_per_step": wavenet_flops.train_step_flops(c, c["batch_size"]),
                     "checked": sut["checked"], "losses": sut["losses"][:CHECKED_STEPS],
                     "mu1": sut["mu1"], "params3": sut["params3"],
                     "items": sut["items"]})


def close(sut) -> None:
    sut["batches"].close()
    sut["state"] = None


# -- correctness --------------------------------------------------------------

def _windows(c, items):
    """The reference's windows of the corpus: {samples key: (item, offset)}."""
    table = {}
    size = rtrain.receptive_field(c) + c["sample_size"]
    for i, (path, _, _) in enumerate(items):
        wav = rtrain.utterance(c, path)
        for off in rtrain.window_offsets(c, len(wav)):
            table[rtrain.key(wav[off:off + size])] = (i, off)
    return table


def _ref_batches(ctx, run):
    """The reference's batches for the checked ones, and the count of
    windows not found among its own or whose rows, phase or speaker
    disagree, and the largest mel row gap."""
    c = ctx.config[MODEL]
    size = rtrain.receptive_field(c) + c["sample_size"]
    table = _windows(c, run.info["items"])
    mels, bad, gap, out = {}, 0, 0.0, []
    fallback = next(iter(table.values()))
    for b in run.info["checked"]:
        audio, rows, phases = [], [], []
        for i in range(b["audio"].shape[0]):
            found = table.get(rtrain.key(b["audio"][i]))
            bad += found is None or int(b["speaker_ids"][i]) != 0
            item, off = found or fallback
            path = run.info["items"][item][0]
            if path not in mels:
                wav = rtrain.utterance(c, path)
                mels[path] = (wav, rdsp.featurize(wav, c)[1])
            wav, mel = mels[path]
            r, phase = rtrain.window_rows(c, mel, off)
            audio.append(wav[off:off + size])
            rows.append(r)
            phases.append(phase)
            if r.shape != b["mel"][i].shape:
                bad += 1
            else:
                bad += int(b["mel_phase"][i]) != phase
                gap = max(gap, float(np.abs(r - b["mel"][i]).max()))
        out.append((torch.from_numpy(np.stack(audio)).to(ctx.device),
                    torch.from_numpy(np.stack(rows)).to(ctx.device), phases))
    return out, bad, gap


def check(ctx, run, control: bool = False):
    c, dev = ctx.config[MODEL], ctx.device
    lim = ctx.params["limits"]
    batches, bad, feat_gap = _ref_batches(ctx, run)
    (start,) = weights.make([rwavenet.param_shapes(c)], ctx.seed, SALT, dev)
    with precision(False):
        losses, g1, p3 = rtrain.train(c, start, batches)
    p0 = rtrain.leaves(start)
    keep = torch.stack([g.double().norm() for g in g1])
    keep = keep >= 1e-3 * keep.median()
    if control:
        with precision(True):
            p_losses, p_g1, p_p3 = rtrain.train(c, start, batches)
    else:
        b1 = c["adam"]["beta1"]
        p_losses = run.info["losses"]
        p_g1 = [m.to(dev) / (1 - b1) for m in rtrain.leaves(run.info["mu1"])]
        p_p3 = [x.to(dev) for x in rtrain.leaves(run.info["params3"])]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(p_losses, losses))
    grad_gap = TRAIN_LOOP._worst_leaf(p_g1, g1, keep)
    change_gap = TRAIN_LOOP._worst_leaf([a - b for a, b in zip(p_p3, p0)],
                                        [a - b for a, b in zip(p3, p0)], keep)
    out = [Compare("loss_rel_gap", loss_gap, lim["loss_rel_gap"]),
           Compare("grad_leaf_gap", grad_gap, lim["grad_leaf_gap"]),
           Compare("change_leaf_gap", change_gap, lim["change_leaf_gap"])]
    if not control:
        out = [Compare("windows_wrong", bad, 0),
               Compare("feature_gap", feat_gap, lim["feature_gap"])] + out
    return out


@contextlib.contextmanager
def _half_batch():
    """The loss of the windows of the first half alone, where the program
    takes the mean over the whole batch."""
    from nspeech_tpu_torch.models import wavenet as W
    orig = W.WaveNet.loss

    def half(self, logits, targets, params=None, l2_strength=None):
        h = logits.shape[0] // 2
        return orig(self, logits[:h], targets[:h], params=params, l2_strength=l2_strength)

    W.WaveNet.loss = half
    try:
        yield
    finally:
        W.WaveNet.loss = orig


@contextlib.contextmanager
def _state_unchanged():
    """A step that returns its parameters unchanged (its optimizer state
    and step count advance)."""
    from nspeech_tpu_torch.train import loop
    orig = loop.build_wavenet_train_step

    def build(*a, **k):
        step = orig(*a, **k)

        def same(state, batch, generator=None):
            new, metrics = step(state, batch, generator)
            return state._replace(step=new.step, opt_state=new.opt_state), metrics
        return same

    loop.build_wavenet_train_step = build
    try:
        yield
    finally:
        loop.build_wavenet_train_step = orig


FAULTS = {"half_batch": _half_batch, "state_unchanged": _state_unchanged}
