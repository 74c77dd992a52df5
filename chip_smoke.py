"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the WaveNet sampler
   kernel from ``nspeech_tpu_torch/csrc`` and prints its build time, the
   ptxas register / shared-memory report and how many of its 8-CTA
   clusters (one per stream) run at once at full width.
2. Holds the kernel against its plain PyTorch version (``WaveNet.generate``)
   at full vocoder width (wavenet hparams + lc_channels=80, gc_channels=16,
   gc_category_cardinality=4, seeded weights and mel): B=1 without
   speakers and B=4 with per-stream speakers, each at temperature 0 and 1,
   over N_CHECK samples; the ``simple_wavenet`` preset (no conditioning,
   the kernel's M = 0) at B=1, temperature 0 and 1, over N_SIMPLE samples;
   and a batch of at least 17 streams, one more than the card runs at
   once, so that the clusters run in waves (N_WAVES samples, T=1). Codes
   drift apart after one rounding flip, so the check is teacher-forced:
   the kernel's codes are fed to the plain generator as its inputs, and
   at every step the kernel's code must score within SCORE_TOL of the
   plain version's best score (same Philox noise).
3. Holds the kernel's carried-state launches (the streaming form) against
   one launch and against the plain version: launches of N_CHECK samples
   split as CARRY_SPLIT must give the codes of one launch, in the same 4
   cases; a launch resumed at sample RESUME_T0 from a carry the kernel
   made must score within SCORE_TOL of the plain ``WaveNet.sample`` from
   the same carry, teacher-forced, and leave the same carry (t0, code and
   prev exactly, rings within RING_TOL relative).
4. Holds the kernel's primed launches (PRIME_LEN forced seed codes, then
   N_PRIMED kept samples, in the same 4 cases) against the plain
   ``WaveNet.generate(seed_codes=...)``, teacher-forced (every kept code
   within SCORE_TOL of the plain best score), and against an unprimed
   launch whose own first PRIME_LEN inputs are the seed (identical kept
   codes).
5. Runs the two CLIs in-process on the card from serving checkpoints
   written into a temporary directory: ``cli.generate_wavenet`` primed
   from a seeded 1 s wav with a seeded mel and ``--gc-id 1`` (CLI_SAMPLES
   samples; counts the primed launches), then with ``--stream-chunk 2000``
   (carried launches), then ``cli.synthesize`` with a full-width
   Tacotron-2 checkpoint and the vocoder checkpoint (one-shot launches).
   Prints the wall times, samples/s and the priming time.
6. Serves 3 ``TextToSpeech.synthesize`` requests and one
   ``synthesize_batch`` of 4 with speaker ids at full Tacotron-2 and
   WaveNet width (seeded weights, decoder cut to MAX_ITERS steps), counts
   the sampler's launches on that path and checks every waveform. Before
   them, a batch with a gc id past the vocoder's table must raise
   ``ClientError`` without a launch; the requests after it show that the
   process's CUDA context is still usable.
7. Streams at the same widths through ``StreamingTTS`` (chunk_frames=40,
   growth=4, T=1): one ``stream`` and one ``stream_batch`` of 2 with
   speakers. Prints time to first audio, wall time, chunk sizes, the time
   from each launch to its chunk's delivery and audio seconds per wall
   second; counts the carried launches on that path; checks that each
   stream equals ``WaveNetVocoder.vocode_batch`` of the stream's own mel
   at the same seed and that the mel is within MEL_TOL of
   ``Tacotron2.forward``'s.
8. Prints each form's time per sample (per step for the primed form)
   beside its bound, one ``{"kernels": [...]}`` line (one-shot, carried
   and primed records) and, last, the
   ``{"ok": true, "device": ...}`` line. Exits non-zero without a card or
   when any check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_CHECK = 2000          # samples per kernel-vs-plain case
N_SIMPLE = 600          # samples per simple_wavenet (M = 0) case
N_WAVES = 200           # samples of the batch that runs in waves
SCORE_TOL = 1e-3        # f32 logits summed in another order, same noise
CARRY_SPLIT = (700, 1, 1299)   # carried launches that make N_CHECK samples
RESUME_T0 = 30000       # where the resumed carried launch starts
N_RESUME = 300          # samples of the resumed launch
RING_TOL = 1e-3         # rings after the resume, relative to their largest
PRIME_LEN = 600         # forced codes per primed kernel case
N_PRIMED = 300          # samples kept after them
CLI_SAMPLES = 4000      # samples per generation CLI run
MAX_ITERS = 40          # decoder steps per request: 200 frames at r=5
MEL_TOL = 1e-3          # windowed vs full-buffer postnet (float32 convs)
VOCODER_HPARAMS = "lc_channels=80,gc_channels=16,gc_category_cardinality=4"
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 1) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def vocoder(seed: int):
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.wavenet import WaveNet
    from nspeech_tpu_torch.ops.layers import tree_to

    cfg = load_config("wavenet").parse(VOCODER_HPARAMS)
    net = WaveNet(cfg)
    return cfg, net, tree_to(net.init(seed), "cuda")


def seeded_lc(seed: int, batch: int, n: int, hop: int) -> torch.Tensor:
    from nspeech_tpu_torch.ops.upsample import upsample_on_device

    frames = n // hop + 1
    mel = np.random.default_rng(seed).random((batch, frames, 80))
    return upsample_on_device(torch.tensor(mel, dtype=torch.float32,
                                           device="cuda"), hop, n)


def sampler_bound(packed, batch: int, n: int, m: int, flops: float,
                  carried: bool = False, prime_len: int = 0):
    """(least time in ms, "bytes" or "operations"): each weight, lc value,
    seed code and code moved once (and, for a carried launch, the carry
    read and written once), against the float32 operations of the
    recurrence."""
    weight_bytes = sum(v.numel() * v.element_size() for v in packed.values())
    moved = (weight_bytes + batch * n * m * 4 + batch * n * 4
             + batch * prime_len * 4)
    if carried:
        ring_rows = int(packed["dilations"].sum())
        R = packed["wc"].shape[2]
        moved += 2 * batch * (ring_rows * R * 4 + 2 * 4)
    t_bytes, t_ops = moved / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def sampler_flops(net, batch: int, n: int) -> float:
    R, DC, S, Q, M = (net.residual_channels, net.dilation_channels,
                      net.skip_channels, net.quantization_channels,
                      net.lc_channels)
    L = len(net.dilations)
    macs = L * ((2 * R + M) * 2 * DC + DC * R + DC * S) + S * S + S * Q
    return 2.0 * macs * batch * n


def check_case(net, params, batch, gc_ids, temperature, seed, n=N_CHECK,
               label="wavenet"):
    """Kernel vs plain, teacher-forced, over n samples. Returns a result
    dict."""
    from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
    from nspeech_tpu_torch.ops.philox import gumbel_noise

    Q = net.quantization_channels
    lc = seeded_lc(seed, batch, n, 250) if net.lc_channels else None
    gen = CudaWaveNetGenerator(net, params, gc_ids=gc_ids)
    gen(n, seed=seed, batch=batch, lc=lc, temperature=temperature)
    torch.cuda.synchronize()
    codes = None

    def run():
        nonlocal codes
        codes = gen(n, seed=seed, batch=batch, lc=lc, temperature=temperature)

    ms = cuda_ms(run)
    inputs = torch.cat([torch.full((batch, 1), Q // 2, device="cuda",
                                   dtype=torch.int32), codes[:, :-1]], dim=1)
    _, logits = net.generate(params, 0, seed=seed, batch=batch, gc_ids=gc_ids,
                             lc=lc, seed_codes=inputs, temperature=temperature,
                             return_logits=True, include_prime=True)
    if temperature > 0:
        g = gumbel_noise(seed, torch.arange(n, device="cuda"), batch, Q)
        scores = logits * (1.0 / temperature) + g.permute(1, 0, 2)
    else:
        scores = logits
    best = scores.max(dim=-1).values
    chosen = scores.gather(-1, codes.long()[..., None])[..., 0]
    gap = (best - chosen).max().item()
    differ = (scores.argmax(dim=-1) != codes.long()).nonzero()
    first = None if differ.numel() == 0 else int(differ[:, 1].min())
    ok = bool(np.isfinite(gap) and gap <= SCORE_TOL
              and int(codes.min()) >= 0 and int(codes.max()) < Q)
    gc_note = gc_ids if gc_ids is None or len(gc_ids) <= 4 else f"{len(gc_ids)} ids"
    print(f"kernel vs plain, {label}, B={batch} gc={gc_note} T={temperature}: "
          f"max score gap {gap:.3g} (tol {SCORE_TOL}), first differing "
          f"argmax at step {first}, kernel {ms:.3f} ms for {n} samples "
          f"({ms * 1e3 / n:.1f} us per sample) -> {'ok' if ok else 'FAIL'}")
    return {"ok": ok, "gap": gap, "ms": ms, "gen": gen, "lc": lc}


def kernel_phase():
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.wavenet import WaveNet
    from nspeech_tpu_torch.ops.cuda import build, wavenet_gen
    from nspeech_tpu_torch.ops.layers import tree_to

    t0 = time.perf_counter()
    _, report = build.build("wavenet_gen.cu")
    print(f"built wavenet_gen.cu in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())
    _, net, params = vocoder(0)
    results = []
    for batch, gc_ids in ((1, None), (4, [0, 1, 2, 3])):
        for temperature in (0.0, 1.0):
            results.append(check_case(net, params, batch, gc_ids,
                                      temperature, seed=11 + batch))
    clusters = wavenet_gen.SAMPLER.max_active_clusters(results[0]["gen"].packed)
    print(f"active 8-CTA clusters at full width: {clusters} (streams that run "
          f"at once; a larger batch runs in waves)")
    snet = WaveNet(load_config("simple_wavenet"))
    sparams = tree_to(snet.init(7), "cuda")
    for temperature in (0.0, 1.0):
        results.append(check_case(snet, sparams, 1, None, temperature, seed=51,
                                  n=N_SIMPLE, label="simple_wavenet (M = 0)"))
    waves = max(17, clusters + 1)
    results.append(check_case(net, params, waves, None, 1.0, seed=61,
                              n=N_WAVES, label=f"{waves} streams in waves"))
    # the main path's single-request shape: B=1, T=1 (results[1])
    main = results[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.generate(params, N_CHECK, seed=12, batch=1, lc=main["lc"],
                 temperature=1.0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by = sampler_bound(main["gen"].packed, 1, N_CHECK,
                                       net.lc_channels,
                                       sampler_flops(net, 1, N_CHECK))
    record = {
        "name": "wavenet_sampler",
        "route": "cuda",
        "source": "nspeech_tpu_torch/csrc/wavenet_gen.cu",
        "replaces": "nspeech_tpu/ops/pallas/wavenet_gen.py:537",
        "max_abs_err": max(r["gap"] for r in results),
        "ms": main["ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "checked": all(r["ok"] for r in results),
        "shape": f"B=1, {N_CHECK} samples, full width",
    }
    print(f"sampler {record['ms']:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{record['bound_ms']:.4f} ms at B=1 x {N_CHECK} samples")
    b4_bound, _ = sampler_bound(results[3]["gen"].packed, 4, N_CHECK,
                                net.lc_channels, sampler_flops(net, 4, N_CHECK))
    record["per_sample"] = [
        ("K1, B=1, T=1", main["ms"] / N_CHECK, bound_ms / N_CHECK),
        ("K2, B=4 with gc, T=1", results[3]["ms"] / N_CHECK, b4_bound / N_CHECK)]
    record["active_clusters"] = clusters
    return record


def carried_case(net, params, batch, gc_ids, temperature, seed):
    """Carried launches of CARRY_SPLIT vs one launch: identical codes."""
    from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator

    lc = seeded_lc(seed, batch, N_CHECK, 250)
    gen = CudaWaveNetGenerator(net, params, gc_ids=gc_ids)
    one = gen(N_CHECK, seed=seed, batch=batch, lc=lc, temperature=temperature)
    carry, parts, s = gen.chunk_carry0(batch), [], 0
    for n in CARRY_SPLIT:
        codes, carry = gen.generate_chunk(carry, n, seed=seed,
                                          lc=lc[:, s:s + n],
                                          temperature=temperature)
        parts.append(codes)
        s += n
    same = (torch.equal(torch.cat(parts, dim=1), one) and carry[0] == N_CHECK
            and torch.equal(carry[1], one[:, -1])
            and torch.equal(carry[2], one[:, -2]))
    print(f"carried launches {CARRY_SPLIT} vs one launch of {N_CHECK}, "
          f"B={batch} gc={gc_ids} T={temperature}: identical {same}")
    return same


def resume_case(net, params, batch, gc_ids, temperature, seed):
    """A carry the kernel made at RESUME_T0, resumed by the kernel and by
    the plain version, teacher-forced; returns (ok, gap, gen, carry, lc)."""
    from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
    from nspeech_tpu_torch.ops.philox import gumbel_noise

    Q = net.quantization_channels
    lc = seeded_lc(seed, batch, RESUME_T0 + N_RESUME, 250)
    gen = CudaWaveNetGenerator(net, params, gc_ids=gc_ids)
    _, carry = gen.generate_chunk(gen.chunk_carry0(batch), RESUME_T0, seed=seed,
                                  lc=lc[:, :RESUME_T0], temperature=temperature)
    lc_r = lc[:, RESUME_T0:]
    codes, k_carry = gen.generate_chunk(carry, N_RESUME, seed=seed, lc=lc_r,
                                        temperature=temperature)
    inputs = torch.cat([carry[1][:, None].long(), codes[:, :-1].long()], dim=1)
    logits = []
    _, p_carry = net.sample(params, carry, N_RESUME, seed,
                            net._embed_gc(params, gc_ids), lc_r, temperature,
                            forced=inputs, logits_all=logits)
    scores = torch.stack(logits, dim=1)
    if temperature > 0:
        t = torch.arange(RESUME_T0, RESUME_T0 + N_RESUME, device=codes.device)
        scores = (scores * (1.0 / temperature)
                  + gumbel_noise(seed, t, batch, Q).permute(1, 0, 2))
    chosen = scores.gather(-1, codes.long()[..., None])[..., 0]
    gap = (scores.max(dim=-1).values - chosen).max().item()
    differ = (scores.argmax(dim=-1) != codes.long()).nonzero()
    first = None if differ.numel() == 0 else int(differ[:, 1].min())
    ring_err = ((k_carry[3] - p_carry[3]).abs().max()
                / p_carry[3].abs().max()).item()
    same = (k_carry[0] == p_carry[0] == RESUME_T0 + N_RESUME
            and torch.equal(k_carry[1], p_carry[1])
            and torch.equal(k_carry[2], p_carry[2]))
    ok = bool(np.isfinite(gap) and gap <= SCORE_TOL and ring_err <= RING_TOL
              and same)
    print(f"carried launch of {N_RESUME} resumed at t0={RESUME_T0} vs plain "
          f"from the kernel's carry, B={batch} gc={gc_ids} T={temperature}: "
          f"max score gap {gap:.3g} (tol {SCORE_TOL}), first differing argmax "
          f"at step {first}, rings after: relative max |diff| {ring_err:.3g} "
          f"(tol {RING_TOL}), t0/code/prev equal {same} -> "
          f"{'ok' if ok else 'FAIL'}")
    return ok, gap, gen, carry, lc_r


def carried_phase():
    _, net, params = vocoder(0)
    same = [carried_case(net, params, batch, gc_ids, temperature, 21 + batch)
            for batch, gc_ids in ((1, None), (4, [0, 1, 2, 3]))
            for temperature in (0.0, 1.0)]
    ok4, gap4, _, _, _ = resume_case(net, params, 4, [0, 1, 2, 3], 1.0, 31)
    ok1, gap1, gen, carry, lc = resume_case(net, params, 1, None, 1.0, 32)
    # timed at the streaming path's single-stream shape (B=1, T=1), far
    # into a stream
    n_timed = N_RESUME
    gen.generate_chunk(carry, n_timed, seed=32, lc=lc, temperature=1.0)
    ms = cuda_ms(lambda: gen.generate_chunk(carry, n_timed, seed=32, lc=lc,
                                            temperature=1.0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.generate_chunk(params, carry, n_timed, seed=32, lc=lc, temperature=1.0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by = sampler_bound(gen.packed, 1, n_timed, net.lc_channels,
                                       sampler_flops(net, 1, n_timed),
                                       carried=True)
    record = {
        "name": "wavenet_sampler_carried",
        "route": "cuda",
        "source": "nspeech_tpu_torch/csrc/wavenet_gen.cu",
        "replaces": "nspeech_tpu/ops/pallas/wavenet_gen.py:537",
        "max_abs_err": max(gap4, gap1),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "checked": all(same) and ok4 and ok1,
        "shape": f"B=1, one launch of {n_timed} samples resumed at "
                 f"t0={RESUME_T0}, full width",
    }
    print(f"carried sampler {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms at B=1 x {n_timed} samples from t0={RESUME_T0}")
    record["per_sample"] = [("K4, B=1, T=1, from t0=30000", ms / n_timed,
                             bound_ms / n_timed)]
    return record


def primed_flops(net, batch: int, prime_len: int, n: int) -> float:
    """The work the kept codes of a primed launch need: the layer stack
    for all P - 1 + n steps, the skip sum and the post-net for the n kept
    steps only."""
    R, DC, S, Q, M = (net.residual_channels, net.dilation_channels,
                      net.skip_channels, net.quantization_channels,
                      net.lc_channels)
    L = len(net.dilations)
    stack = L * ((2 * R + M) * 2 * DC + DC * R)
    head = L * DC * S + S * S + S * Q
    return 2.0 * batch * ((prime_len - 1 + n) * stack + n * head)


def primed_case(net, params, batch, gc_ids, temperature, seed):
    """Primed kernel launch (PRIME_LEN forced codes, N_PRIMED kept) vs the
    plain version fed the seed and then the kernel's codes, teacher-forced;
    and vs one unprimed launch whose own inputs are the seed: the kept
    codes must be identical. Returns a result dict."""
    from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
    from nspeech_tpu_torch.ops.philox import gumbel_noise

    Q, P, n = net.quantization_channels, PRIME_LEN, N_PRIMED
    lc = seeded_lc(seed, batch, P + n, 250)
    gen = CudaWaveNetGenerator(net, params, gc_ids=gc_ids)
    # an unprimed launch over P + n samples; its first P inputs (the
    # mid-scale code, then its own codes) become the seed
    free = gen(P + n, seed=seed, batch=batch, lc=lc, temperature=temperature)
    seeds = torch.cat([torch.full((batch, 1), Q // 2, device="cuda",
                                  dtype=torch.int32), free[:, :P - 1]], dim=1)
    seeds = seeds.contiguous()
    gen(n, seed=seed, batch=batch, seed_codes=seeds, lc=lc,
        temperature=temperature)
    torch.cuda.synchronize()
    codes = None

    def run():
        nonlocal codes
        codes = gen(n, seed=seed, batch=batch, seed_codes=seeds, lc=lc,
                    temperature=temperature)

    ms = cuda_ms(run)
    same = torch.equal(codes, free[:, P - 1:P - 1 + n])
    inputs = torch.cat([seeds, codes[:, :-1]], dim=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, logits = net.generate(params, 0, seed=seed, batch=batch, gc_ids=gc_ids,
                             lc=lc, seed_codes=inputs, temperature=temperature,
                             return_logits=True, include_prime=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    scores = logits[:, P - 1:]
    if temperature > 0:
        g = gumbel_noise(seed, torch.arange(P - 1, P - 1 + n, device="cuda"),
                         batch, Q)
        scores = scores * (1.0 / temperature) + g.permute(1, 0, 2)
    chosen = scores.gather(-1, codes.long()[..., None])[..., 0]
    gap = (scores.max(dim=-1).values - chosen).max().item()
    ok = bool(np.isfinite(gap) and gap <= SCORE_TOL and same
              and int(codes.min()) >= 0 and int(codes.max()) < Q)
    print(f"primed kernel (P={P}, n={n}) B={batch} gc={gc_ids} T={temperature}: "
          f"max score gap vs plain {gap:.3g} (tol {SCORE_TOL}), kept codes == "
          f"unprimed launch fed the same inputs {same}, kernel {ms:.3f} ms "
          f"({ms * 1e3 / (P - 1 + n):.1f} us per step), plain {plain_ms:.1f} ms "
          f"-> {'ok' if ok else 'FAIL'}")
    return {"ok": ok, "gap": gap, "ms": ms, "plain_ms": plain_ms, "gen": gen}


def primed_phase():
    _, net, params = vocoder(0)
    results = [primed_case(net, params, batch, gc_ids, temperature, 41 + batch)
               for batch, gc_ids in ((1, None), (4, [0, 1, 2, 3]))
               for temperature in (0.0, 1.0)]
    main = results[1]                  # B=1, T=1
    bound_ms, bound_by = sampler_bound(
        main["gen"].packed, 1, PRIME_LEN - 1 + N_PRIMED, net.lc_channels,
        primed_flops(net, 1, PRIME_LEN, N_PRIMED), prime_len=PRIME_LEN)
    record = {
        "name": "wavenet_sampler_primed",
        "route": "cuda",
        "source": "nspeech_tpu_torch/csrc/wavenet_gen.cu",
        "replaces": "nspeech_tpu/ops/pallas/wavenet_gen.py:537",
        "max_abs_err": max(r["gap"] for r in results),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "checked": all(r["ok"] for r in results),
        "shape": f"B=1, {PRIME_LEN} forced codes + {N_PRIMED} samples "
                 f"(one launch of {PRIME_LEN - 1 + N_PRIMED} steps), full width",
    }
    print(f"primed sampler {record['ms']:.3f} ms, plain {record['plain_ms']:.1f} "
          f"ms (teacher-forced), bound {bound_ms:.4f} ms at B=1 x "
          f"{PRIME_LEN - 1 + N_PRIMED} steps")
    steps = PRIME_LEN - 1 + N_PRIMED
    record["per_sample"] = [("K3, B=1, T=1, per step (P=600, n=300)",
                             main["ms"] / steps, bound_ms / steps)]
    return record


def cli_phase(tmp: str):
    """The two CLIs on the card, from serving checkpoints written into
    ``tmp``: ``generate_wavenet`` primed from a seed wav (K3), then
    streamed (K4), then ``synthesize`` (Tacotron-2 + vocoder, K1). Returns
    (ok, primed launches on the primed run)."""
    import contextlib
    import io
    import os

    from scipy.io import wavfile

    from nspeech_tpu_torch.cli import generate_wavenet, synthesize
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.train import save_serving_checkpoint

    vcfg, net, vparams = vocoder(3)
    voc_dir = os.path.join(tmp, "vocoder")
    save_serving_checkpoint(voc_dir, 1000, "wavenet", vcfg, vparams)
    rng = np.random.default_rng(5)
    sr = vcfg.sample_rate
    t = np.arange(sr) / sr
    seed = 0.6 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal(sr)
    seed_path = os.path.join(tmp, "seed.wav")
    wavfile.write(seed_path, sr, (np.clip(seed, -1, 1) * 32767).astype(np.int16))
    mel_path = os.path.join(tmp, "mel.npy")
    frames = (net.receptive_field + CLI_SAMPLES) // 250 + 2
    np.save(mel_path, rng.random((frames, 80)).astype(np.float32))
    counters = (wavenet_gen.SAMPLER, wavenet_gen.PRIMED_SAMPLER,
                wavenet_gen.CARRIED_SAMPLER)

    def run(main, argv):
        for c in counters:
            c.launches = 0
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            print("  |", line)
        return wall, [c.launches for c in counters], out.getvalue()

    ok = True
    primed_wav = os.path.join(tmp, "primed.wav")
    wall, (one, primed, carried), out = run(generate_wavenet.main, [
        voc_dir, "--wav_seed", seed_path, "--mel-npy", mel_path, "--gc-id", "1",
        "--samples", str(CLI_SAMPLES), "--wav_out_path", primed_wav])
    wav = wavfile.read(primed_wav)[1]
    gen_s = float(out.split("Generated %d samples in " % CLI_SAMPLES)[1].split("s")[0])
    good = (primed >= 1 and one == 0 and wav.size == CLI_SAMPLES
            and f"Primed with {net.receptive_field} seed samples" in out)
    ok &= good
    primed_launches = primed
    # the priming alone: a launch of the same seed with one kept sample
    gen = wavenet_gen.CudaWaveNetGenerator(net, vparams, gc_ids=[1])
    seeds = torch.randint(0, net.quantization_channels,
                          (1, net.receptive_field), dtype=torch.int32,
                          device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    lc = seeded_lc(6, 1, net.receptive_field + 1, 250)
    gen(1, seed_codes=seeds, lc=lc)
    prime_ms = cuda_ms(lambda: gen(1, seed_codes=seeds, lc=lc))
    print(f"cli generate_wavenet primed: {wall:.3f} s wall, generation "
          f"{gen_s:.2f} s as printed ({CLI_SAMPLES / gen_s:.0f} samples/s incl. "
          f"priming), priming alone {prime_ms:.1f} ms for {net.receptive_field} "
          f"forced codes ({prime_ms / (gen_s * 1e3):.1%} of the generation); "
          f"launches one-shot {one}, primed {primed}, carried {carried}; wav "
          f"{wav.size} samples -> {'ok' if good else 'FAIL'}")

    stream_wav = os.path.join(tmp, "stream.wav")
    wall, (one, primed, carried), out = run(generate_wavenet.main, [
        voc_dir, "--mel-npy", mel_path, "--gc-id", "2", "--samples",
        str(CLI_SAMPLES), "--stream-chunk", "2000", "--wav_out_path", stream_wav])
    size = (os.path.getsize(stream_wav) - 44) // 2
    good = carried >= 1 and one == 0 and primed == 0 and size == CLI_SAMPLES
    ok &= good
    print(f"cli generate_wavenet --stream-chunk 2000: {wall:.3f} s wall, "
          f"launches carried {carried}; wav {size} samples -> "
          f"{'ok' if good else 'FAIL'}")

    tcfg = load_config("taco2")
    model = Tacotron2(tcfg)
    params, bn = model.init(1)
    taco_dir = os.path.join(tmp, "taco2")
    save_serving_checkpoint(taco_dir, 2000, "taco2", tcfg, params, bn)
    del params, bn
    synth_wav = os.path.join(tmp, "synth.wav")
    wall, (one, primed, carried), out = run(synthesize.main, [
        "--checkpoint", taco_dir, "--hparams", f"max_iters={MAX_ITERS}",
        "--vocoder-checkpoint", voc_dir, "--text", "Speech from two checkpoints.",
        "--out", synth_wav])
    sr_out, wav = wavfile.read(synth_wav)
    good = one >= 1 and wav.size > 0 and sr_out == sr
    ok &= good
    print(f"cli synthesize: {wall:.3f} s wall (checkpoint loads included), "
          f"launches one-shot {one}; wav {wav.size} samples -> "
          f"{'ok' if good else 'FAIL'}")
    return ok, primed_launches


def e2e_phase():
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.serving import (ClientError, Synthesizer,
                                           TextToSpeech, WaveNetVocoder)

    cfg = load_config("taco2").parse(f"max_iters={MAX_ITERS}")
    print(f"end to end: taco2 full width, max_iters={MAX_ITERS} "
          f"({MAX_ITERS * cfg.outputs_per_step} frames), vocoder {VOCODER_HPARAMS}")
    model = Tacotron2(cfg)
    params, bn = model.init(1)
    syn = Synthesizer(cfg).set_variables(params, bn, model=model)
    vcfg, net, vparams = vocoder(2)
    voc = WaveNetVocoder(vcfg).set_variables(net, vparams)
    tts = TextToSpeech(syn, voc)
    vocoded = []                     # (samples, seconds) per vocoder call
    vocode_batch = voc.vocode_batch

    def timed_vocode_batch(mels, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = vocode_batch(mels, *args, **kwargs)   # ends in a device->host copy
        vocoded.append((out.size, time.perf_counter() - t0))
        return out

    voc.vocode_batch = timed_vocode_batch
    texts = ["The quick brown fox jumps over the lazy dog.",
             "Hello world, this is a test of the port.",
             "Speech synthesis on one card.",
             "Four streams share one batched sampler call."]
    tts.synthesize(texts[0])                   # warm-up: cuDNN, cuFFT plans
    torch.cuda.synchronize()
    ok = True
    # an id past the vocoder's gc table: refused before any launch, and the
    # requests below run on the same CUDA context
    bad = vcfg.gc_category_cardinality
    before = wavenet_gen.SAMPLER.launches
    try:
        tts.synthesize_batch(texts[:2], speaker_ids=[0, bad])
        print(f"FAIL: gc id {bad} was served")
        ok = False
    except ClientError as e:
        good = wavenet_gen.SAMPLER.launches == before
        ok &= good
        print(f"batch with gc id {bad}: ClientError ({e}), launches during it "
              f"{wavenet_gen.SAMPLER.launches - before} -> {'ok' if good else 'FAIL'}")
    vocoded.clear()
    wavenet_gen.SAMPLER.launches = 0
    wavenet_gen.CARRIED_SAMPLER.launches = 0
    for i, text in enumerate(texts[:3]):
        t0 = time.perf_counter()
        wav, mel, _ = tts.synthesize(text, temperature=1.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        good = wav.size > 0 and bool(np.isfinite(wav).all())
        ok &= good
        n, vs = vocoded[-1]
        print(f"request {i}: {dt:.3f} s wall, mel {mel.shape}, {n} samples "
              f"vocoded in {vs:.3f} s, wav {wav.size} samples, finite {good}")
    t0 = time.perf_counter()
    wavs, mels, _ = tts.synthesize_batch(texts, speaker_ids=[0, 1, 2, 3])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    good = all(w.size > 0 and np.isfinite(w).all() for w in wavs)
    ok &= good
    n, vs = vocoded[-1]
    print(f"batch of 4: {dt:.3f} s wall, mels {mels.shape}, {n} samples "
          f"vocoded in {vs:.3f} s, wav lengths {[w.size for w in wavs]}, "
          f"finite {good}")
    samples = sum(n for n, _ in vocoded)
    seconds = sum(s for _, s in vocoded)
    launches = wavenet_gen.SAMPLER.launches
    print(f"vocoder {samples / seconds:.1f} samples/s over {len(vocoded)} calls; "
          f"sampler launches {launches}")
    if launches < 4:
        print("FAIL: the main path did not launch the sampler kernel "
              "once per vocoded call")
        ok = False
    return ok, launches


def streaming_phase():
    """Returns (ok, carried launches on the streaming path)."""
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.serving import (StreamingTTS, Synthesizer,
                                           WaveNetVocoder)

    cfg = load_config("taco2").parse(f"max_iters={MAX_ITERS}")
    print(f"streaming: taco2 full width, max_iters={MAX_ITERS}, vocoder "
          f"{VOCODER_HPARAMS}, chunk_frames=40, growth=4, T=1")
    model = Tacotron2(cfg)
    params, bn = model.init(1)
    syn = Synthesizer(cfg).set_variables(params, bn, model=model)
    vcfg, net, vparams = vocoder(2)
    voc = WaveNetVocoder(vcfg).set_variables(net, vparams)
    tts = StreamingTTS(syn, voc, chunk_frames=40, temperature=1.0, growth=4)
    cases = [("stream of 1", ["The quick brown fox jumps over the lazy dog."],
              None),
             ("stream_batch of 2", ["Hello world, this is a test of the port.",
                                    "Speech synthesis on one card."], [0, 1])]
    wavenet_gen.SAMPLER.launches = 0
    wavenet_gen.CARRIED_SAMPLER.launches = 0
    runs = []
    for name, texts, speakers in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, sizes, parts = None, [], [[] for _ in texts]
        for chunks in tts.stream_batch(texts, speakers):
            if first is None:
                first = time.perf_counter() - t0
            sizes.append([0 if c is None else len(c) for c in chunks])
            for i, c in enumerate(chunks):
                if c is not None:
                    parts[i].append(c)
        wall = time.perf_counter() - t0
        runs.append((name, texts, speakers, first, wall, sizes,
                     [np.concatenate(p) for p in parts],
                     list(tts.last_launch_to_delivery), tts.last_mel_batch,
                     [m.shape[0] for m in tts.last_mels]))
    launches = wavenet_gen.CARRIED_SAMPLER.launches
    one_shot = wavenet_gen.SAMPLER.launches
    ok = launches > 0 and one_shot == 0
    for (name, texts, speakers, first, wall, sizes, wavs, l2d, mel_batch,
         totals) in runs:
        audio = sum(w.size for w in wavs) / cfg.sample_rate
        ref = voc.vocode_batch(mel_batch, speakers, temperature=1.0)
        equal = all(np.array_equal(w, ref[i, : w.size]) and
                    w.size == totals[i] * tts._hop for i, w in enumerate(wavs))
        finite = all(np.isfinite(w).all() and w.size > 0 for w in wavs)
        mels = one_shot_mels(syn, texts, speakers)
        gap = float(np.abs(mel_batch - mels[:, : mel_batch.shape[1]]).max())
        good = equal and finite and gap <= MEL_TOL
        ok &= good
        print(f"{name}: time to first audio {first:.3f} s, wall {wall:.3f} s, "
              f"{len(sizes)} chunks {[list(c) for c in zip(*sizes)]}, "
              f"{audio:.3f} s of audio, {audio / wall:.4f} audio s per wall s, "
              f"launch to delivery {[round(x, 3) for x in l2d]} s, finite "
              f"{finite}, equals vocode_batch {equal}, mel vs Tacotron2.forward "
              f"max |diff| {gap:.3g} (tol {MEL_TOL}) -> {'ok' if good else 'FAIL'}")
    print(f"carried sampler launches on the streaming path {launches} "
          f"(one-shot launches {one_shot})")
    if launches == 0:
        print("FAIL: streaming did not launch the carried kernel")
    return ok, launches


def one_shot_mels(syn, texts, speakers):
    """``Tacotron2.forward``'s mel for the stream's padded batch."""
    from nspeech_tpu_torch.text import text_to_sequence

    n = max(1, 1 << (len(texts) - 1).bit_length())
    seqs = [text_to_sequence(t, syn._cleaners) for t in texts]
    width = -(-max(len(q) for q in seqs) // 32) * 32
    ids = torch.zeros(n, width, dtype=torch.int64)
    lengths = torch.zeros(n, dtype=torch.int64)
    for i, q in enumerate(seqs):
        ids[i, : len(q)] = torch.tensor(q)
        lengths[i] = len(q)
    spk = torch.zeros(n, dtype=torch.int64)
    if speakers is not None:
        spk[: len(texts)] = torch.tensor(speakers)
    out = syn.model.forward(syn._params, syn._bn_state, ids.to(syn.device),
                            lengths.to(syn.device), spk.to(syn.device))
    return out["mel_outputs"][: len(texts)].cpu().numpy()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke runs on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    start = time.perf_counter()
    record = kernel_phase()
    carried = carried_phase()
    primed = primed_phase()
    e2e_ok, record["launches"] = e2e_phase()
    stream_ok, carried["launches"] = streaming_phase()
    with tempfile.TemporaryDirectory() as tmp:
        cli_ok, primed["launches"] = cli_phase(tmp)
    print(f"smoke took {time.perf_counter() - start:.1f} s after the card line")
    for rec in (record, carried, primed):
        for form, ms, bound in rec.pop("per_sample"):
            print(f"{form}: {ms * 1e3:.2f} us per sample, bound {bound * 1e3:.4f} "
                  f"us ({ms / bound:.0f} x the bound)")
    print(json.dumps({"kernels": [record, carried, primed]}))
    if not (record["checked"] and carried["checked"] and primed["checked"]
            and e2e_ok and stream_ok and cli_ok):
        print("FAIL", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
