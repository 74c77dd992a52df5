"""Tacotron-2 training: the port's train step over its feeder, as
``cli.train`` configures them, for the whole window.

Set-up writes a synthetic corpus in LJSpeech's layout under ``TMPDIR``
(``corpus_clips`` clips whose durations are the quantiles of LJSpeech's
range, harmonic tones with a slow envelope and noise, loud throughout so
that the silence trim keeps them whole; texts from the benchmark's
generator at ``chars_per_s``), builds ``DataFeeder`` (batch groups and
100-frame buckets of the configuration), ``build_tacotron_train_step``
with its defaults (deferred weight gradients, clip, Adam) and a state
from the benchmark's seeded weights, and runs one epoch of steps: the
feeder featurizes the corpus once (its memo), and every padded shape of
the window occurs (each epoch's batches are the same length-sorted
groups). Each step is the runner's: the batch to the card, the step
with the step's generator, the loss read on the host.

Correctness: the first three steps of set-up against the plain
reference: the batch's rows, lengths and features (the reference reads
the same WAV files and featurizes them itself), then each step's loss,
the first gradient as Adam got it (its first moment after step 1 over
1 - beta1) and the parameters' change over the three steps, each by its
worst leaf; the reference draws the prenet's dropout masks from a
generator seeded as the step's, in the order the step draws them."""

from __future__ import annotations

import atexit
import contextlib
import os
import shutil
import tempfile

import numpy as np
import torch

from benchmark.harness import flops, gen, weights
from benchmark.harness.core import Compare, Run, now
from benchmark.harness.trace import span
from benchmark.reference import dsp as rdsp
from benchmark.reference import precision
from benchmark.reference import taco2 as rtaco2
from benchmark.reference import text as rtext

SALT = 3
MODEL = "taco2"
CHECKED_STEPS = 3


def _corpus(ctx, root: str):
    """Write the corpus; returns [(wav path, text, samples)]."""
    from scipy.io import wavfile
    p, c = ctx.params, ctx.config[MODEL]
    sr = c["sample_rate"]
    n = int(p["corpus_clips"])
    durs = gen.durations(ctx.seed, n, p["clip_min_s"], p["clip_max_s"], p["clip_mean_s"])
    lengths = np.clip(np.rint(durs * p["chars_per_s"]), p["text_min"], p["text_max"]).astype(int)
    rng = np.random.default_rng([int(ctx.seed) & (2 ** 64 - 1), 5])
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    items, lines, seen = [], [], set()
    for i, (d, L) in enumerate(zip(durs, lengths)):
        text = gen.text_of_length(rng, int(L))
        while text in seen:                       # rows are told apart by text
            text = gen.text_of_length(rng, int(L))
        seen.add(text)
        t = np.arange(int(d * sr)) / sr
        f0 = rng.uniform(90.0, 260.0)
        wav = sum(rng.uniform(0.1, 0.4) / k * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3))
                  for k in range(1, 6))
        wav = wav * (0.7 + 0.3 * np.sin(2 * np.pi * rng.uniform(1.0, 4.0) * t))
        wav = wav + 0.01 * rng.standard_normal(len(t))
        pcm = (np.clip(wav / np.abs(wav).max() * 0.7, -1, 1) * 32767).astype(np.int16)
        uid = "BENCH%04d" % i
        path = os.path.join(root, "wavs", uid + ".wav")
        wavfile.write(path, sr, pcm)
        items.append((path, text, len(pcm)))
        lines.append(f"{uid}|{text}|{text}")
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return items


def _frames(samples: int, c) -> int:
    n_fft, hop, _ = rdsp.stft_params(c)
    return 1 + samples // hop


def setup(ctx):
    from nspeech_tpu_torch.config import Config
    from nspeech_tpu_torch.data.feeder import DataFeeder
    from nspeech_tpu_torch.models import create_model
    from nspeech_tpu_torch.ops.policy import set_matmul_precision
    from nspeech_tpu_torch.train.loop import (TrainState, batch_to_device,
                                              build_tacotron_train_step,
                                              step_generator)
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
    # cli.train's feeder: its default buckets (32 symbols, 100 frames)
    feeder = DataFeeder({"ljspeech": root}, cfg, seed=ctx.seed,
                        bucket_text=int(p["text_bucket"]),
                        bucket_frames=int(p["frame_bucket"]))
    model = create_model(MODEL, cfg)
    optimizer, schedule = make_optimizer(cfg, MODEL)
    step_fn = build_tacotron_train_step(model, optimizer, schedule=schedule,
                                        ema_decay=float(cfg.ema_decay))
    tp, ts = rtaco2.param_shapes(c)
    params, bn = weights.make([tp, ts], ctx.seed, SALT, ctx.device)
    state = TrainState(0, params, bn, optimizer.init(params), None)
    batches = feeder.batches()
    by_text = {tuple(rtext.to_ids(t)): (path, n) for path, t, n in items}
    sut = {"root": root, "batches": batches, "state": state, "step_fn": step_fn,
           "to_device": batch_to_device, "gen": step_generator, "device": device,
           "by_text": by_text, "checked": [], "losses": [], "seed": ctx.seed}
    # one epoch: the corpus featurized, every padded shape warmed; the
    # first steps kept for the comparison
    for k in range(int(p["setup_steps"])):
        b = next(batches)
        if k < CHECKED_STEPS:
            sut["checked"].append({f: np.array(getattr(b, f)) for f in
                                   ("inputs", "input_lengths", "mel_targets",
                                    "linear_targets")})
        _step(sut, b)
        if k == 0:
            sut["mu1"] = _host(sut["state"].opt_state["mu"])
        if k == CHECKED_STEPS - 1:
            sut["params3"] = _host(sut["state"].params)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sut


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host(v) for v in tree]
    return tree.detach().to("cpu", copy=True)


def _step(sut, b) -> float:
    state = sut["state"]
    data = sut["to_device"](b, sut["device"])
    state, metrics = sut["step_fn"](state, data,
                                    sut["gen"](sut["device"], sut["seed"], state.step))
    sut["state"] = state
    loss = float(metrics["loss"])           # the runner's sync per step
    sut["losses"].append(loss)
    return loss


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
        rows = [sut["by_text"].get(tuple(ids[:n]), (None, 0))
                for ids, n in zip(b.inputs.tolist(), b.input_lengths.tolist())]
        frames = [_frames(n, c) for _, n in rows]
        records.append({"t0": t0, "t_batch": t1, "t1": t2,
                        "frames": frames, "t_in": b.input_lengths.tolist(),
                        "padded": list(b.mel_targets.shape[:2]),
                        "unknown_rows": sum(1 for r in rows if r[0] is None)})
        if ctx.trace and k + 1 == trace_from + trace_steps:
            tracer.stop()
            traced["t1"], traced["steps"] = now(), trace_steps
    if ctx.trace and "t1" not in traced and "t0" in traced:
        tracer.stop()
        traced["t1"], traced["steps"] = now(), len(records) - traced["step0"]
    frame_s = c["frame_shift_ms"] / 1000.0
    run = Run(window_s=records[-1]["t1"] - start if records else ctx.seconds,
              records=records,
              counters={"steps": len(records),
                        "unknown_rows": sum(r["unknown_rows"] for r in records)},
              info={"traced": traced, "frame_s": frame_s,
                    "checked": sut["checked"], "losses": sut["losses"][:CHECKED_STEPS],
                    "mu1": sut["mu1"], "params3": sut["params3"],
                    "by_text": sut["by_text"], "root": sut["root"]})
    run.info["flops_per_step"] = [
        sum(flops.taco2_train_flops(c, t, f) for t, f in zip(r["t_in"], r["frames"]))
        for r in records]
    return run


def close(sut) -> None:
    sut["batches"].close()
    sut["state"] = None


# -- correctness --------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _ref_batch(ctx, batch, by_text):
    """The reference's own batch for the program's rows: (ids, lengths,
    mel, linear, rows unknown or in disagreement)."""
    from scipy.io import wavfile
    c = ctx.config[MODEL]
    r = c["outputs_per_step"]
    bad = 0
    feats, ids_rows = [], []
    for ids, n in zip(batch["inputs"].tolist(), batch["input_lengths"].tolist()):
        key = tuple(ids[:n])
        if key not in by_text or any(ids[n:]):
            bad += 1
            key = next(iter(by_text))
        path, _ = by_text[key]
        _, pcm = wavfile.read(path)
        feats.append(rdsp.featurize(pcm.astype(np.float32) / 32768.0, c))
        ids_rows.append(list(key))
    t_text = rtext.round_up(max(len(i) for i in ids_rows), int(ctx.params["text_bucket"]))
    t_out = rtext.round_up(rtext.round_up(max(len(f[0]) for f in feats) + 1, r),
                           int(ctx.params["frame_bucket"]))
    n = len(feats)
    ids = np.zeros((n, t_text), np.int64)
    lin = np.zeros((n, t_out, c["num_freq"]), np.float32)
    mel = np.zeros((n, t_out, c["num_mels"]), np.float32)
    for i, ((li, me), row) in enumerate(zip(feats, ids_rows)):
        ids[i, :len(row)] = row
        lin[i, :len(li)] = li
        mel[i, :len(me)] = me
    lengths = np.array([len(x) for x in ids_rows])
    return ids, lengths, mel, lin, bad


def _ref_train(ctx, batches, tf32: bool):
    """The reference's three steps: (losses, first clipped gradient,
    parameters after the three, initial parameters)."""
    c, dev = ctx.config[MODEL], ctx.device
    tp, ts = rtaco2.param_shapes(c)
    p0, bn = weights.make([tp, ts], ctx.seed, SALT, dev)
    params = _map(lambda t: t.detach().clone(), p0)
    leaves = list(_leaves(params))
    b1, b2 = c["adam"]["beta1"], c["adam"]["beta2"]
    mu = [torch.zeros_like(x) for x in leaves]
    nu = [torch.zeros_like(x) for x in leaves]
    losses, g1 = [], None
    keep = 1.0 - c["drop_rate"]
    for s, (ids, lengths, mel, lin) in enumerate(batches):
        ids_t = torch.from_numpy(ids).to(dev)
        len_t = torch.from_numpy(lengths).to(dev)
        mel_t, lin_t = torch.from_numpy(mel).to(dev), torch.from_numpy(lin).to(dev)
        g = torch.Generator(device=dev)
        g.manual_seed((int(ctx.seed) * 1_000_003 + s) % (2 ** 63))   # the step's
        n = ids.shape[0]
        masks = [(torch.rand((n, rtaco2.PRENET[0]), generator=g, device=dev) < keep,
                  torch.rand((n, rtaco2.PRENET[1]), generator=g, device=dev) < keep)
                 for _ in range(mel.shape[1] // c["outputs_per_step"])]
        for x in leaves:
            x.requires_grad_(True)
        with precision(tf32):
            m_out, l_out = rtaco2.forward_train(c, params, bn, ids_t, len_t, mel_t, masks)
            loss = rtaco2.loss(c, m_out, l_out, mel_t, lin_t)
            grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((gr * gr).sum() for gr in grads))
            grads = [gr if norm < 1.0 else gr / norm for gr in grads]
            if g1 is None:
                g1 = [gr.clone() for gr in grads]
            lr = c["initial_learning_rate"] * 0.5 ** (s / c["learning_rate_decay_halflife"])
            for j, (x, gr) in enumerate(zip(leaves, grads)):
                mu[j] = (1 - b1) * gr + b1 * mu[j]
                nu[j] = (1 - b2) * gr * gr + b2 * nu[j]
                x.requires_grad_(False)
                x -= lr * (mu[j] / (1 - b1 ** (s + 1))) / (
                    torch.sqrt(nu[j] / (1 - b2 ** (s + 1))) + 1e-8)
    return losses, g1, [x.detach() for x in leaves], list(_leaves(p0))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _worst_leaf(prog, ref, keep):
    """Largest |norm(prog) - norm(ref)| over the kept leaves, against the
    larger of the leaf's reference norm and the median leaf's."""
    pn = torch.stack([x.double().norm() for x in prog])
    rn = torch.stack([x.double().norm() for x in ref])
    med = rn[keep].median()
    gap = (pn - rn).abs() / torch.maximum(rn, med)
    return float(gap[keep].max())


def check(ctx, run, control: bool = False):
    c, dev = ctx.config[MODEL], ctx.device
    lim = ctx.params["limits"]
    bad, feat_gap, ref_batches = 0, 0.0, []
    for b in run.info["checked"]:
        ids, lengths, mel, lin, wrong = _ref_batch(ctx, b, run.info["by_text"])
        bad += wrong + int(ids.shape != b["inputs"].shape
                           or mel.shape != b["mel_targets"].shape
                           or not np.array_equal(lengths, b["input_lengths"]))
        if mel.shape == b["mel_targets"].shape:
            feat_gap = max(feat_gap, float(np.abs(mel - b["mel_targets"]).max()),
                           float(np.abs(lin - b["linear_targets"]).max()))
        ref_batches.append((ids, lengths, mel, lin))
    losses, g1, p3, p0 = _ref_train(ctx, ref_batches, False)
    keep = torch.stack([g.double().norm() for g in g1])
    keep = keep >= 1e-3 * keep.median()
    if control:
        p_losses, p_g1, p_p3, _ = _ref_train(ctx, ref_batches, True)
    else:
        b1 = c["adam"]["beta1"]
        p_losses = run.info["losses"]
        p_g1 = [m.to(dev) / (1 - b1) for m in _leaves(run.info["mu1"])]
        p_p3 = [x.to(dev) for x in _leaves(run.info["params3"])]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(p_losses, losses))
    grad_gap = _worst_leaf(p_g1, g1, keep)
    change_gap = _worst_leaf([a - b for a, b in zip(p_p3, p0)],
                             [a - b for a, b in zip(p3, p0)], keep)
    out = [Compare("loss_rel_gap", loss_gap, lim["loss_rel_gap"]),
           Compare("grad_leaf_gap", grad_gap, lim["grad_leaf_gap"]),
           Compare("change_leaf_gap", change_gap, lim["change_leaf_gap"])]
    if not control:
        out = [Compare("batch_rows_wrong", bad, 0),
               Compare("feature_gap", feat_gap, lim["feature_gap"])] + out
    return out


@contextlib.contextmanager
def _half_batch():
    """The loss of the rows of the first half alone, where the program
    takes its mean."""
    from nspeech_tpu_torch.models import tacotron2 as T
    orig = T.Tacotron2.loss

    def half(self, outputs, mel_targets, linear_targets):
        h = mel_targets.shape[0] // 2
        return orig(self, {k: v[:h] if v.dim() and v.shape[0] == mel_targets.shape[0]
                           else v for k, v in outputs.items()},
                    mel_targets[:h], linear_targets[:h])

    T.Tacotron2.loss = half
    try:
        yield
    finally:
        T.Tacotron2.loss = orig


FAULTS = {"half_batch": _half_batch}
