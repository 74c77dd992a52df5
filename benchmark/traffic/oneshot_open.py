"""One-shot requests in an open loop: text -> Tacotron -> Griffin-Lim, the
whole waveform at once, through the demo server's dynamic batcher.

System under test: ``DynamicBatcher(max_batch, window_ms)`` over
``Synthesizer.synthesize_batch`` (``nspeech_tpu_torch.serving``) with
seeded weights at the configuration's widths, as the demo server's
``/synthesize`` route drives it with ``--dynamic-batch``: each answer is
the waveform, the mel and the linear spectrogram. The decoder runs
``decode_steps`` steps. A proxy between the batcher and the synthesizer
records each group: its start, its end and its rows.

Correctness: a sample of the window's requests drawn from the seed (the
longest text among them) against the plain references: the symbol ids
exactly, the decoded mel and the post-CBHG linear spectrogram by their
largest absolute gaps, and the waveform's length (Griffin-Lim, inverse
pre-emphasis and the endpoint trim) exactly. The waveform's samples are
not compared: on a random model's spectrogram Griffin-Lim's 60
iterations grow float32 rounding into gaps of several percent (the
port's batched and single-row runs of the same spectrogram differ so),
the same size as the control's (``PERF.md``)."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark.harness import flops, gen, openloop, weights
from benchmark.harness.core import Compare, Run, now
from benchmark.harness.trace import span
from benchmark.reference import dsp as rdsp
from benchmark.reference import precision
from benchmark.reference import taco1 as rtaco1
from benchmark.reference import text as rtext

SALT = 2
MODEL = "taco1"


class OneShotProxy:
    """Stands between the batcher and the synthesizer: each group's span
    and rows."""

    def __init__(self, synth, traced):
        self._synth = synth
        self._traced = traced
        self.groups = []
        self.row_of = {}

    def synthesize_batch(self, texts, speaker_ids=None):
        from nspeech_tpu_torch.text import text_to_sequence
        t0 = now()
        gi = len(self.groups)
        g = {"t0": t0, "n": len(texts),
             "ids": [text_to_sequence(t, ["english_cleaners"]) for t in texts]}
        self.groups.append(g)
        for row, t in enumerate(texts):
            self.row_of[id(t)] = (gi, row)
        with span("synthesize_batch", self._traced):
            out = self._synth.synthesize_batch(texts, speaker_ids)
        g["t1"] = now()
        return out


def _config(ctx):
    from nspeech_tpu_torch.config import Config
    c = dict(ctx.config[MODEL])
    c["max_iters"] = int(ctx.params["decode_steps"])
    return Config(c)


def setup(ctx):
    from nspeech_tpu_torch.serving.batcher import DynamicBatcher
    from nspeech_tpu_torch.serving.synthesizer import Synthesizer

    p = ctx.params
    shapes = rtaco1.param_shapes(ctx.config[MODEL])
    params, bn = weights.make(list(shapes), ctx.seed, SALT, ctx.device)
    synth = Synthesizer(_config(ctx), text_bucket=int(p["text_bucket"]),
                        device=ctx.device).set_variables(params, bn, model=MODEL)
    long_text = gen.texts(ctx.seed, 1, p["text_max"], p["text_max"])[0]
    n = 1
    while n <= p["max_batch"]:              # every padded group size
        synth.synthesize_batch([long_text] * n)
        n *= 2
    if ctx.device != "cpu":
        torch.cuda.synchronize()
    proxy = OneShotProxy(synth, ctx.trace)
    batcher = DynamicBatcher(proxy, max_batch=int(p["max_batch"]),
                             window_ms=float(p["window_ms"]))
    return {"batcher": batcher, "proxy": proxy}


def window(ctx, sut, tracer) -> Run:
    p = ctx.params
    times = gen.arrivals(ctx.seed, float(p["rate"]), ctx.seconds)
    texts = gen.texts(ctx.seed, len(times), int(p["text_min"]), int(p["text_max"]))
    keep = set(gen.check_sample(ctx.seed, texts, p["check_requests"]))
    proxy, batcher = sut["proxy"], sut["batcher"]

    def client(rec):
        wav, mel, lin = batcher.synthesize(rec["text"], timeout=600.0)
        rec["done"] = now()
        rec["samples"] = len(wav)
        if rec["i"] in keep:
            rec["wav"], rec["mel"], rec["lin"] = np.asarray(wav, np.float32), mel, lin

    traced = {}
    if ctx.trace:
        # the profiler starts and stops in this thread; the loop runs
        # beside it and the trace covers its first trace_seconds
        import threading
        out = {}
        tracer.start()
        start = traced["t0"] = now()
        th = threading.Thread(target=lambda: out.update(recs=openloop.drive(
            times, texts, client, start, float(p["drain_s"]))))
        th.start()
        time.sleep(max(0.0, start + float(p["trace_seconds"]) - now()))
        tracer.stop()
        traced["t1"] = now()
        th.join()
        recs = out["recs"]
    else:
        recs = openloop.drive(times, texts, client, now(), float(p["drain_s"]))
    for r in recs:
        gi, row = proxy.row_of.get(id(r["text"]), (None, None))
        if gi is not None:
            r.update(group=gi, row=row, group_t0=proxy.groups[gi]["t0"])
    run = Run(window_s=ctx.seconds, records=recs,
              counters={"lateness_s": openloop.lateness(recs),
                        "groups": len(proxy.groups),
                        "samples_mean": float(np.mean([r.get("samples", 0) for r in recs]))},
              info={"groups": proxy.groups, "checked": sorted(keep),
                    "drain_s": float(p["drain_s"]), "traced": traced})
    run.info["flops"] = work_flops(ctx, run)
    return run


def close(sut) -> None:
    sut["batcher"].close()


def work_flops(ctx, run) -> float:
    """FLOPs of the groups inside the traced span, each group's share by
    the part of its span that lies inside: Tacotron-1 to the linear
    spectrogram and Griffin-Lim, real rows only."""
    tr = run.info["traced"]
    if "t1" not in tr:
        return 0.0
    c, steps = ctx.config[MODEL], int(ctx.params["decode_steps"])
    total = 0.0
    for g in run.info["groups"]:
        if "t1" not in g:
            continue
        inside = min(g["t1"], tr["t1"]) - max(g["t0"], tr["t0"])
        if inside <= 0:
            continue
        f = sum(flops.taco1_serve_flops(c, len(ids), steps)
                + flops.griffin_lim_flops(c, steps * c["outputs_per_step"])
                for ids in g["ids"])
        total += f * inside / (g["t1"] - g["t0"])
    return total


# -- correctness --------------------------------------------------------------

def _reference(ctx, params, bn, text, group, row, tf32):
    """(ids, mel, linear, waveform length) of the reference for one
    request."""
    c = ctx.config[MODEL]
    dev = ctx.device
    ids = rtext.to_ids(text)
    padded = rtext.round_up(max(len(x) for x in group["ids"]), int(ctx.params["text_bucket"]))
    x = torch.zeros(1, padded, dtype=torch.long, device=dev)
    x[0, :len(ids)] = torch.tensor(ids, device=dev)
    n_pad = 1 << (group["n"] - 1).bit_length()
    with precision(tf32):
        mel, linear = rtaco1.infer(c, params, bn, x, torch.tensor([len(ids)], device=dev),
                                   int(ctx.params["decode_steps"]))
        phase = torch.from_numpy(rdsp.initial_phase(n_pad, row, tuple(linear.shape[1:]))).to(dev)
        wav = rdsp.griffin_lim(linear[0], phase, c)
    wav = rdsp.inv_preemphasis(wav.cpu().numpy(), c["preemphasis"])
    return ids, mel[0].cpu().numpy(), linear[0].cpu().numpy(), rdsp.find_endpoint(wav, c)


def _gap(a, b) -> float:
    return 1e30 if a.shape != b.shape else float(np.abs(a - b).max())


def check(ctx, run, control: bool = False):
    shapes = rtaco1.param_shapes(ctx.config[MODEL])
    params, bn = weights.make(list(shapes), ctx.seed, SALT, ctx.device)
    bad = len_err = 0
    mel_gap = lin_gap = 0.0
    by_i = {r["i"]: r for r in run.records}
    for i in run.info["checked"]:
        rec = by_i[i]
        if "error" in rec or "wav" not in rec or rec.get("group") is None:
            bad += 1
            continue
        g = run.info["groups"][rec["group"]]
        ids, mel, lin, length = _reference(ctx, params, bn, rec["text"], g, rec["row"], False)
        if control:
            _, p_mel, p_lin, p_len = _reference(ctx, params, bn, rec["text"], g, rec["row"], True)
        else:
            p_mel, p_lin, p_len = rec["mel"], rec["lin"], len(rec["wav"])
            bad += int(list(g["ids"][rec["row"]]) != list(ids))
        len_err = max(len_err, abs(p_len - length))
        mel_gap = max(mel_gap, _gap(p_mel, mel))
        lin_gap = max(lin_gap, _gap(p_lin, lin))
    lim = ctx.params["limits"]
    out = [Compare("mel_max_abs_gap", mel_gap, lim["mel_max_abs_gap"]),
           Compare("linear_max_abs_gap", lin_gap, lim["linear_max_abs_gap"])]
    if not control:
        out = [Compare("ids_or_requests_wrong", bad, 0),
               Compare("wave_len_err", len_err, 0)] + out
    return out


@contextlib.contextmanager
def _answer_altered():
    """One bin of every linear spectrogram moved by 0.01, where the model
    produces it (Griffin-Lim then inverts the altered answer)."""
    from nspeech_tpu_torch.models import tacotron as T
    orig = T.Tacotron1.forward

    def altered(self, *a, **k):
        out = dict(orig(self, *a, **k))
        lin = out["linear_outputs"].clone()
        lin[:, lin.shape[1] // 2, 7] += 0.01
        out["linear_outputs"] = lin
        return out

    T.Tacotron1.forward = altered
    try:
        yield
    finally:
        T.Tacotron1.forward = orig


FAULTS = {"answer_altered": _answer_altered}
