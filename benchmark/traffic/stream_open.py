"""Streaming requests in an open loop: text -> Tacotron-2 -> mel-conditioned
WaveNet, chunk by chunk, through the demo server's batcher.

System under test: ``StreamBatcher(max_batch, window_ms)`` over
``StreamingTTS(chunk_frames)`` (``nspeech_tpu_torch.serving``) with
seeded weights at the configuration's widths; the decoder runs
``decode_steps`` steps (random weights never stop early). A proxy
between the batcher and the streamer records each group: its start, its
first chunk, its end, its rows, the carried sampler's launches and the
streamer's post-netted mels.

Correctness: a sample of the window's requests drawn from the seed (the
longest text among them) against the plain references: the symbol ids
exactly, the post-netted mel by its largest absolute gap, the waveform
on the mu-law grid with the full length, and each served code by how far
its reference score (logit plus the sampler's Gumbel noise) lies below
the best one, the reference's network conditioned on its own mel."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.harness import flops, gen, openloop, weights
from benchmark.harness.core import Compare, Run, now
from benchmark.harness.trace import span
from benchmark.reference import dsp as rdsp
from benchmark.reference import precision
from benchmark.reference import taco2 as rtaco2
from benchmark.reference import text as rtext
from benchmark.reference import wavenet as rwavenet

SALT = 1


class StreamProxy:
    """Stands between the batcher and the streamer: each group's spans,
    rows and mels."""

    def __init__(self, inner, traced, sampler):
        self._inner = inner
        self._traced = traced
        self._sampler = sampler
        self.groups = []
        self.row_of = {}            # id(text) -> (group index, row)
        self.keep_mels = set()      # ids of the texts whose mel is kept

    def stream_batch(self, texts, speaker_ids=None):
        from nspeech_tpu_torch.text import text_to_sequence
        t0 = now()
        g = {"t0": t0, "n": len(texts), "launches0": self._sampler.launches,
             "ids": [text_to_sequence(t, ["english_cleaners"]) for t in texts]}
        gi = len(self.groups)
        self.groups.append(g)
        for row, t in enumerate(texts):
            self.row_of[id(t)] = (gi, row)
        with span("stream_batch", self._traced):
            for k, chunks in enumerate(self._inner.stream_batch(texts, speaker_ids)):
                if k == 0:
                    g["t_first"] = now()
                yield chunks
        g["t1"] = now()
        g["launches"] = self._sampler.launches - g["launches0"]
        g["mels"] = {row: self._inner.last_mels[row] for row, t in enumerate(texts)
                     if id(t) in self.keep_mels}


def _configs(ctx):
    from nspeech_tpu_torch.config import Config
    t2 = dict(ctx.config["taco2"])
    t2["max_iters"] = int(ctx.params["decode_steps"])
    return Config(t2), Config(dict(ctx.config["wavenet"]))


def setup(ctx):
    from nspeech_tpu_torch.models import WaveNet
    from nspeech_tpu_torch.ops.cuda.wavenet_gen import CARRIED_SAMPLER
    from nspeech_tpu_torch.serving.batcher import StreamBatcher
    from nspeech_tpu_torch.serving.pipeline import WaveNetVocoder
    from nspeech_tpu_torch.serving.streaming import StreamingTTS
    from nspeech_tpu_torch.serving.synthesizer import Synthesizer

    p = ctx.params
    cfg, wcfg = _configs(ctx)
    tp, ts = rtaco2.param_shapes(ctx.config["taco2"])
    wp = rwavenet.param_shapes(ctx.config["wavenet"])
    params, bn, wparams = weights.make([tp, ts, wp], ctx.seed, SALT, ctx.device)
    synth = Synthesizer(cfg, device=ctx.device).set_variables(params, bn, model="taco2")
    vocoder = WaveNetVocoder(wcfg, device=ctx.device).set_variables(WaveNet(wcfg), wparams)
    streamer = StreamingTTS(synth, vocoder, chunk_frames=int(p["chunk_frames"]),
                            temperature=float(p["temperature"]),
                            text_bucket=int(p["text_bucket"]))
    # warm-up: the first chunk at every padded group size, then one whole
    # group of the largest; texts of the longest bucket
    long_text = gen.texts(ctx.seed, 1, p["text_max"], p["text_max"])[0]
    n = 1
    while n < p["max_batch"]:
        chunks = streamer.stream_batch([long_text] * n)
        next(chunks)
        chunks.close()
        n *= 2
    for _ in streamer.stream_batch([long_text] * n):
        pass
    if ctx.device != "cpu":
        torch.cuda.synchronize()
    proxy = StreamProxy(streamer, ctx.trace, CARRIED_SAMPLER)
    batcher = StreamBatcher(proxy, max_batch=int(p["max_batch"]),
                            window_ms=float(p["window_ms"]))
    return {"batcher": batcher, "proxy": proxy, "streamer": streamer}


def window(ctx, sut, tracer) -> Run:
    p = ctx.params
    times = gen.arrivals(ctx.seed, float(p["rate"]), ctx.seconds)
    texts = gen.texts(ctx.seed, len(times), int(p["text_min"]), int(p["text_max"]))
    keep = set(gen.check_sample(ctx.seed, texts, p["check_requests"]))
    proxy, batcher = sut["proxy"], sut["batcher"]
    proxy.keep_mels = {id(texts[i]) for i in keep}

    def client(rec):
        wav = [] if rec["i"] in keep else None
        samples, first_samples = 0, 0
        for chunk in batcher.stream(rec["text"], timeout=600.0):
            if samples == 0:
                rec["first"] = now()
                first_samples = len(chunk)
            samples += len(chunk)
            if wav is not None:
                wav.append(chunk)
        rec["last"] = now()
        rec["samples"], rec["first_samples"] = samples, first_samples
        if wav is not None:
            rec["wav"] = np.concatenate(wav) if wav else np.zeros(0, np.float32)

    tracer.start()
    start = now()
    recs = openloop.drive(times, texts, client, start, float(p["drain_s"]))
    tracer.stop()
    end = now()
    for r in recs:
        gi, row = proxy.row_of.get(id(r["text"]), (None, None))
        if gi is not None:
            g = proxy.groups[gi]
            r.update(group=gi, row=row, group_t0=g["t0"], group_first=g.get("t_first"))
    run = Run(window_s=ctx.seconds, records=recs,
               counters={"lateness_s": openloop.lateness(recs),
                         "launches": sum(g.get("launches", 0) for g in proxy.groups)},
               trace=None,
               info={"groups": [{k: v for k, v in g.items() if k != "mels"}
                                for g in proxy.groups],
                     "mels": {(gi, row): m for gi, g in enumerate(proxy.groups)
                              for row, m in g.get("mels", {}).items()},
                     "checked": sorted(keep), "traced_s": end - start,
                     "drain_s": float(p["drain_s"]),
                     "sample_rate": ctx.config["taco2"]["sample_rate"]})
    run.info["flops"] = work_flops(ctx, run)
    return run


def close(sut) -> None:
    sut["batcher"].close()
    sut["batcher"]._worker.join(timeout=30.0)


def work_flops(ctx, run) -> dict:
    """FLOPs of the served work of the run's groups, real rows only: the
    Tacotron-2 decode and postnet, and the sampler per sample."""
    t2, wn = ctx.config["taco2"], ctx.config["wavenet"]
    steps = int(ctx.params["decode_steps"])
    taco = sampler = 0
    for g in run.info["groups"]:
        for ids in g["ids"]:
            taco += flops.taco2_serve_flops(t2, len(ids), steps)
    per = flops.sampler_sample_flops(wn)
    samples = sum(r.get("samples", 0) for r in run.records if "error" not in r)
    sampler = per * samples
    return {"taco": taco, "sampler": sampler, "samples": samples}


# -- correctness --------------------------------------------------------------

def _reference(ctx, params, bn, wparams, rec, group_ids, tf32: bool):
    """(mel, logits) of the reference for one request."""
    t2, wn = ctx.config["taco2"], ctx.config["wavenet"]
    dev = ctx.device
    ids = rtext.to_ids(rec["text"])
    padded = rtext.round_up(max(len(x) for x in group_ids), int(ctx.params["text_bucket"]))
    x = torch.zeros(1, padded, dtype=torch.long, device=dev)
    x[0, :len(ids)] = torch.tensor(ids, device=dev)
    with precision(tf32):
        mel = rtaco2.infer_mel(t2, params, bn, x, torch.tensor([len(ids)], device=dev),
                               int(ctx.params["decode_steps"]))[0]
        _, hop, _ = rdsp.stft_params(t2)
        n = mel.shape[0] * hop
        table = torch.from_numpy(rdsp.mu_law_table(wn["quantization_channels"])).to(dev)
        wav = torch.from_numpy(np.asarray(rec["wav"], np.float32)).to(dev)
        codes = torch.argmin((wav[:n, None] - table[None, :]).abs(), dim=1)
        inputs = torch.cat([torch.tensor([wn["quantization_channels"] // 2], device=dev),
                            codes[:-1]])
        logits = rwavenet.logits(wn, wparams, inputs, rdsp.upsample(mel, hop, n))
    return ids, mel, codes, logits


def check(ctx, run, control: bool = False):
    """The comparison of the sampled requests; ``control`` puts the
    reference in TF32 in the program's place."""
    t2, wn = ctx.config["taco2"], ctx.config["wavenet"]
    Q = wn["quantization_channels"]
    tp, ts = rtaco2.param_shapes(t2)
    params, bn, wparams = weights.make([tp, ts, rwavenet.param_shapes(wn)],
                                       ctx.seed, SALT, ctx.device)
    table = torch.from_numpy(rdsp.mu_law_table(Q)).to(ctx.device)
    _, hop, _ = rdsp.stft_params(t2)
    want = int(ctx.params["decode_steps"]) * t2["outputs_per_step"] * hop
    ids_bad = len_err = 0
    grid = mel_gap = tok_gap = 0.0
    by_i = {r["i"]: r for r in run.records}
    for i in run.info["checked"]:
        rec = by_i[i]
        if "error" in rec or "wav" not in rec or rec.get("group") is None:
            ids_bad += 1
            continue
        g = run.info["groups"][rec["group"]]
        prog_ids = g["ids"][rec["row"]]
        ids, mel, codes, logits = _reference(ctx, params, bn, wparams, rec, g["ids"], False)
        wav = torch.from_numpy(np.asarray(rec["wav"], np.float32)).to(ctx.device)
        noise = rwavenet.gumbel(int(ctx.params["sampler_seed"]),
                                torch.arange(len(codes), device=ctx.device), rec["row"], Q)
        z = logits / float(ctx.params["temperature"]) + noise
        if control:
            _, mel_c, _, logits_c = _reference(ctx, params, bn, wparams, rec, g["ids"], True)
            prog_mel = mel_c
            served = torch.argmax(logits_c / float(ctx.params["temperature"]) + noise, dim=1)
        else:
            ids_bad += int(list(prog_ids) != list(ids))
            prog_mel = torch.from_numpy(run.info["mels"][(rec["group"], rec["row"])]).to(ctx.device)
            served = codes
            len_err = max(len_err, abs(len(wav) - want))
            n = min(len(wav), want)
            grid = max(grid, float((wav[:n] - table[codes[:n]]).abs().max()))
        if prog_mel.shape != mel.shape:
            mel_gap = 1e30
        else:
            mel_gap = max(mel_gap, float((prog_mel - mel).abs().max()))
        gap = z.max(dim=1).values - z.gather(1, served[:, None])[:, 0]
        tok_gap = max(tok_gap, float(gap.max()))
    lim = ctx.params["limits"]
    out = [Compare("mel_max_abs_gap", mel_gap, lim["mel_max_abs_gap"]),
           Compare("token_score_gap", tok_gap, lim["token_score_gap"])]
    if not control:
        out = [Compare("ids_or_requests_wrong", ids_bad, 0),
               Compare("wave_len_err", len_err, 0),
               Compare("wave_off_grid", grid, lim["wave_off_grid"])] + out
    return out


@contextlib.contextmanager
def _token_altered():
    """The sampler's first code of every chunk of every stream moved up
    by one level, where the codes are produced."""
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    orig = wavenet_gen.CudaWaveNetGenerator.generate_chunk

    def altered(self, *a, **k):
        codes, carry = orig(self, *a, **k)
        codes = codes.clone()
        codes[:, 0] = (codes[:, 0] + 1) % self.net.quantization_channels
        return codes, carry

    wavenet_gen.CudaWaveNetGenerator.generate_chunk = altered
    try:
        yield
    finally:
        wavenet_gen.CudaWaveNetGenerator.generate_chunk = orig


FAULTS = {"token_altered": _token_altered}
