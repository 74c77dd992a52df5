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
   over N_CHECK samples, after a warm launch of the same codes; the
   ``simple_wavenet`` preset (no conditioning, the kernel's M = 0) at
   B=1, temperature 0 and 1, over N_SIMPLE samples;
   and a batch of at least 17 streams, one more than the card runs at
   once, so that the clusters run in waves (N_WAVES samples, T=1). Codes
   drift apart after one rounding flip, so the check is teacher-forced:
   the kernel's codes are fed to the plain generator as its inputs, and
   at every step the kernel's code must score within SCORE_TOL of the
   plain version's best score (same Philox noise). Before any code is
   used as an index, every launch's codes must lie in [0, Q): a bad
   launch prints its first bad step and the codes' range and fails its
   case, where an out-of-range index would end the CUDA context with a
   device-side assert. The warm launch must equal the checked one.
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
   Tacotron-2 checkpoint and the vocoder checkpoint (one-shot launches),
   then ``cli.eval --skip-harvard`` through the vocoder (8 wavs and 16
   PNGs). Prints the wall times, samples/s and the priming time.
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
8. Serves Tacotron-1 at its published widths (``taco1`` preset, seeded
   weights, MAX_ITERS steps): two requests and a batch of 2 through
   ``TextToSpeech``, one stream at T=0 through ``StreamingTTS`` (equal to
   ``vocode_batch`` of its own mel), then each other attention type
   through Griffin-Lim; every mel within TACO_TOL of the CPU forward of
   the same weights.
9. Runs the demo server (``cli/demo_server.py``) over the full-width
   Tacotron-2 and the vocoder with a ``DynamicBatcher`` (8, 50 ms) and a
   ``StreamBatcher`` (4, 50 ms), after its ``_warmup``, on a free port of
   127.0.0.1: 8 concurrent ``/synthesize``, 4 concurrent
   ``/synthesize_stream``, a ``/synthesize_batch`` of 3, a long-form text
   through the batcher, then ``/stats``. Checks every WAV, the 400 for a
   bad ``speaker_id``, ``max_batch_seen`` >= 2 for both batchers, and
   fewer sampler launches than requests (requests shared launches).
10. Trains on the card (``train_phase``): writes a synthetic
    LJSpeech-layout corpus (TRAIN_UTTS utterances of 1-10 s, TEXT_RATE
    characters of Harvard-sentence text per second), featurizes it into a
    cache on the host CPU (timed), runs ``cli.train --model taco2`` at the
    published widths (batch 32, drop_rate 0.5) for TRAIN_STEPS steps with
    checkpoints every 2 (loss and time of each step, sec/step as the
    median of steps 2-TRAIN_STEPS, peak memory), runs it again to resume
    one more step, times WARM_STEPS warm steps at each padded length,
    holds one training step on the card against the same step on the CPU
    (4 short utterances, no dropout, ``card_vs_cpu_step``: the trainer's
    step in float32, loss within STEP_LOSS_TOL relative, the gradient,
    ``grad_norm``, Adam's update and the EMA within STEP_NORM_TOL in
    2-norm, each leaf within STEP_LEAF_TOL of its largest entry; the
    gradient in float64 within STEP_GRAD_TOL of each leaf's largest; the
    weight gradients deferred, the trainer's default), holds the deferred
    float64 gradient against autograd's on the card (STEP_GRAD_TOL), times
    warm steps at batch 32 and T_out 900 in turns autograd, deferred,
    deferred, autograd (TURN_STEPS each, peak memory per turn) and
    profiles one step of each at T_out PROFILE_T_OUT (``scripts/torch_train_profile.py``:
    launches, kernel time, ``aten::add_``'s share and costliest input
    shapes), runs ``cli.synthesize`` from the trained checkpoint with the phase-5
    vocoder (one-shot launches), and trains Tacotron-1 at its published
    widths for 2 steps. The training path reaches no TPU kernel; only the
    synthesis launches the sampler.
11. Trains the vocoder on the card (``wavenet_train_phase``, on the
    training phase's corpus): ``cli.train_wavenet`` at the repo's vocoder
    recipe (the ``wavenet`` preset, 50 layers, + WN_HPARAMS: lc 80, gc 16,
    windows of 5,117 + 20,480 samples, batch 4) for WN_STEPS steps with
    checkpoints every 3 (each step's time, sec/step as the median of
    steps 2-WN_STEPS, audio samples per second, peak memory), resumed for
    one more; one step on the card against the CPU on one window of
    WN_CHECK_WINDOW samples (``wavenet_card_vs_cpu``: float64 gradients
    within WN_GRAD_TOL of each leaf's largest entry; in float32 the loss
    within WN_LOSS_TOL, the gradient, ``grad_norm``, Adam's update and the
    EMA within WN_NORM_TOL in 2-norm, each leaf within WN_LEAF_TOL); then
    ``cli.export_gta`` from the trained Tacotron-2 over the corpus (one
    file per utterance of 1 + trimmed length // hop rows, the manifest's
    fingerprint the config's; timed), ``cli.train_wavenet --gta-dir
    --hparams-from`` for 2 more steps on those mels, ``cli.generate_wavenet``
    from that checkpoint on one exported mel (CLI_SAMPLES samples, K1),
    and ``cli.train --device-cache 2`` for 2 Tacotron-2 steps from batches
    held on the card.
12. Builds the C++ audio loader (``nspeech_tpu_torch/csrc/loader.cpp``)
    with the machine's g++ (``loader_phase``, before phase 5) and holds it
    against the Python copies on a seeded 22,050 Hz WAV (resampled to
    20,000 Hz; within 1e-3) and a 20,000 Hz FLAC (within 1e-6), with the
    ms per utterance of each.
13. Runs the bf16 compute policy (``bf16_phase``, after phase 11): which
    arithmetic a float32 product runs under each ``--matmul-precision``
    (a product whose low mantissa bits tell float32, TF32 and bf16
    apart); a bf16 GEMM and a bf16 cuDNN convolution accumulating in
    float32; Tacotron-2 teacher-forced at the published widths in bf16
    against float32 (BF16_MEL_TOL); two ``TextToSpeech`` requests at bf16
    (one sampler launch each, on float32 mels), one bf16 stream through
    ``StreamingTTS`` (carried launches) and one bf16 Tacotron-1 request;
    ``cli.train`` (Tacotron-2,
    batch 32) and ``cli.train_wavenet`` (the recipe) for BF16_STEPS steps
    each at ``compute_dtype=bfloat16``: float32 masters and optimizer
    state in the checkpoint, finite losses, the first within BF16_LOSS_TOL
    of the float32 run's first step on the same batch; then peak memory
    (each dtype alone) and warm sec/step (steps in turns float32, bf16,
    bf16, float32) of both models.
14. Imports reference (TensorFlow) checkpoints (``import_phase``):
    the reference-named tensors of a seeded Tacotron-2 at its published
    widths and of the vocoder at the recipe (``tests/make_reference_ckpt.py``;
    the mapping the importers take, as this machine has no TensorFlow)
    through ``cli.import_reference_ckpt``'s ``import_checkpoint`` (the
    tree checked on the card), every imported leaf equal to its source,
    one ``cli.synthesize`` request from the two imported checkpoints (one
    one-shot launch) and the imported Tacotron-2's served mel within
    MEL_TOL of the same checkpoint's forward on the CPU.
15. Serves exported artifacts (``export_phase``, after phase 14): the
    full-width Tacotron-2 (EXPORT_ITERS steps, EXPORT_GL_ITERS Griffin-Lim
    iterations) exported on the card through
    ``serving/export.py`` (its decode one ``while_loop``), loaded and
    served, its mel within MEL_TOL of the live ``Synthesizer``'s; the same
    program at EXPORT_CPU_TEXT symbols exported
    on the CPU with platforms
    cpu and cuda and loaded on the card (mel within MEL_TOL of the live
    synthesizer's there); the full-width vocoder exported for
    EXPORT_FRAMES frames at temperature 0 and 1, fed the artifact's mel,
    each waveform equal to the live ``WaveNetVocoder``'s at the same seed
    (the same codes; its sampler is ``nspeech::wavenet_sample``, one K1
    launch per call, counted). Prints export and load times, sizes,
    request latency beside the live path's and samples/s beside the live
    vocoder's.
16. Runs data parallelism on the one card (``parallel_phase``, after
    phase 15, on phase 10's corpus and checkpoint and phase 5's vocoder):
    an NCCL process group of world size 1 in this process; the
    full-width Tacotron-2 data-parallel step at batch 32 and the WaveNet
    step at WN_HPARAMS held to the plain steps (float64 gradients within
    STEP_GRAD_TOL / WN_GRAD_TOL of each leaf's largest entry, float32
    losses within STEP_LOSS_TOL / WN_LOSS_TOL) and timed beside them in
    turns; the time-sharded WaveNet logits equal to the unsharded ones;
    ``torchrun --nproc_per_node 1 -m nspeech_tpu_torch.cli.train`` for 2
    steps, its first loss within STEP_LOSS_TOL of phase 10's float32
    CLI's; ``cli.synthesize --data-parallel`` with the vocoder, its WAV
    equal to the CLI's without the flag (its K1 launches counted). No
    check falls back to the CPU.
17. Runs tensor parallelism on the one card (``tensor_phase``, after
    phase 16): the full-width Tacotron-2 step (batch 32 of
    ``random_batch``, T_out 105, dropout from one generator) with its
    state sharded by ``parallel/tensor.py`` (a) at world size 1 over NCCL
    (data 1 x model 1) in this process and (b) at model 2 in two
    processes of this script (``--tensor-worker``) over gloo, both on
    ``cuda:0``: NCCL refuses two ranks on one card, and gloo carries the
    CUDA tensors of ``all_reduce`` and ``all_gather`` through the host,
    a check configuration and not a path for users. Each holds its
    gathered float64 gradient within STEP_GRAD_TOL of the plain step's
    on the card and its float32 loss within STEP_LOSS_TOL; (a) also runs
    one bf16 step, finite and within TP_BF16_TOL of the plain bf16
    step's loss, and times the plain and the sharded float32 step in
    turns; (b) times each rank's warm steps.
18. Prints each phase's seconds as it ends (``phase <name>: <s> s``),
    each form's time per sample (per step for the primed form)
    beside its bound, one ``{"kernels": [...]}`` line (one-shot, carried
    and primed records; ``launches`` summed over the paths of phases
    5-11 and 13-16, each counted from 0 just before it) and, last, the
    ``{"ok": true, "device": ...}`` line. Exits non-zero without a card
    or when any check fails.
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
EXPORT_FRAMES = 40      # frames of the exported vocoder program (10,000 samples)
EXPORT_ITERS = 8        # decoder steps of the exported Tacotron-2 programs
EXPORT_CPU_TEXT = 16    # text length of the one traced on the CPU (the card's: 64)
EXPORT_GL_ITERS = 4     # Griffin-Lim iterations in export_phase (the checks hold mels)
TACO_TOL = 1e-3         # Tacotron-1 mels, card vs CPU forward (float32, TF32 off)
VOCODER_HPARAMS = "lc_channels=80,gc_channels=16,gc_category_cardinality=4"
TRAIN_UTTS = 64         # synthetic corpus of the training phase, 1-10 s each
TEXT_RATE = 15          # its characters of text per second of audio
TRAIN_STEPS = 4         # first training run; the resumed run adds one
WARM_STEPS = 3          # timed steps per padded length after a warm-up step
TURN_STEPS = 2          # timed steps per turn of the deferred-gradient timing
PROFILE_T_OUT = 500     # padded length of the profiled steps (the turns: the longest, 900)
STEP_LOSS_TOL = 1e-4    # training loss, card vs CPU, relative
STEP_GRAD_TOL = 1e-9    # float64 gradients, card vs CPU, of each leaf's largest entry
STEP_NORM_TOL = 3e-3    # float32 gradient, grad_norm, update, EMA: relative 2-norm
STEP_LEAF_TOL = 0.1     # float32 gradients, of each leaf's largest entry
# the vocoder's training: the repo's recipe (docs/vocoder/README.md)
WN_HPARAMS = "lc_channels=80,gc_channels=16,sample_size=20480,batch_size=4"
WN_STEPS = 6            # first WaveNet run, checkpoints every 3; the resumed run adds one
WN_CHECK_WINDOW = 2048  # samples past the receptive field of the card-vs-CPU window
# Card against CPU, readings on 9 windows of the corpus (the smoke's and
# scripts/torch_train_profile.py --model wavenet's 8): float64 worst
# leaf <= 5.1e-15; float32 loss <= 8.2e-8 relative. A post-net relu input
# within rounding of 0 passes its gradient on one device only: 1-2 of the
# 2.1 M inputs in 4 of the 8 windows, which then moved the float32
# gradient by up to 4.4e-4 in 2-norm (grad_norm 8.3e-5, update 4.6e-6,
# EMA 2.4e-5) and a leaf by up to 2.8e-3 of its largest entry; without a
# flip 4.1e-7 and 2.8e-6.
WN_GRAD_TOL = 1e-9      # float64 gradients, of each leaf's largest entry
WN_LOSS_TOL = 1e-6      # float32 loss, relative
WN_NORM_TOL = 3e-3      # float32 gradient, grad_norm, update, EMA: relative 2-norm
WN_LEAF_TOL = 3e-2      # float32 gradients, of each leaf's largest entry
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3
BF16 = "compute_dtype=bfloat16"
BF16_STEPS = 3          # steps of each bf16 CLI run
BF16_LOSS_TOL = 2e-2    # first bf16 step's loss against the float32 step's, relative
BF16_MEL_TOL = 0.05     # bf16 teacher-forced mels against float32 (atol and rtol, JAX's)
TP_BF16_TOL = 1e-2      # bf16 loss, tensor-parallel against plain step: a few bf16 epsilons
TP_TIMEOUT = 600        # seconds for the two gloo ranks of tensor_phase
LOADER_REPS = 5         # loads per file and loader when timing
FIRST_LOSS = {}         # the float32 CLI runs' first losses, by model


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


def repo_module(path: str):
    """The repository's ``path`` (relative to this file) as a module, loaded
    by path: another package may own a name such as ``tests`` here."""
    import importlib.util
    import os

    full = os.path.join(os.path.dirname(os.path.abspath(__file__)), path)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], full)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def code_range_fault(codes: torch.Tensor, q: int):
    """None when every code of ``codes`` [B, T] lies in [0, q); else the
    first step holding a code outside it and the codes' range. Read before
    the codes index anything: an out-of-range index on the card is a
    device-side assert that ends the process's CUDA context."""
    bad = ((codes < 0) | (codes >= q)).any(dim=0).nonzero()
    if bad.numel() == 0:
        return None
    return {"step": int(bad[0, 0]), "min": int(codes.min()),
            "max": int(codes.max())}


def range_fail(what: str, bad: dict, q: int) -> str:
    return (f"{what}: codes outside [0, {q}) from step {bad['step']}, codes "
            f"in [{bad['min']}, {bad['max']}] -> FAIL")


def check_case(net, params, batch, gc_ids, temperature, seed, n=N_CHECK,
               label="wavenet"):
    """Kernel vs plain, teacher-forced, over n samples: the codes' range
    first (a bad launch reports itself before its codes index the plain
    generator), then the warm launch's codes against the checked
    launch's, then the scores. Returns a result dict."""
    from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
    from nspeech_tpu_torch.ops.philox import gumbel_noise

    Q = net.quantization_channels
    lc = seeded_lc(seed, batch, n, 250) if net.lc_channels else None
    gen = CudaWaveNetGenerator(net, params, gc_ids=gc_ids)
    warm = gen(n, seed=seed, batch=batch, lc=lc, temperature=temperature)
    torch.cuda.synchronize()
    codes = None

    def run():
        nonlocal codes
        codes = gen(n, seed=seed, batch=batch, lc=lc, temperature=temperature)

    ms = cuda_ms(run)
    what = f"kernel vs plain, {label}, B={batch} T={temperature}"
    for launch, out in (("warm", warm), ("checked", codes)):
        bad = code_range_fault(out, Q)
        if bad is not None:
            print(range_fail(f"{what}, {launch} launch", bad, Q))
            return {"ok": False, "gap": float("inf"), "ms": ms, "gen": gen,
                    "lc": lc}
    repeat = torch.equal(warm, codes)
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
    ok = bool(np.isfinite(gap) and gap <= SCORE_TOL and repeat)
    gc_note = gc_ids if gc_ids is None or len(gc_ids) <= 4 else f"{len(gc_ids)} ids"
    print(f"kernel vs plain, {label}, B={batch} gc={gc_note} T={temperature}: "
          f"max score gap {gap:.3g} (tol {SCORE_TOL}), first differing "
          f"argmax at step {first}, warm launch == checked launch {repeat}, "
          f"kernel {ms:.3f} ms for {n} samples "
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
    for what, out in (("carry", carry[1][:, None]), ("resumed launch", codes)):
        bad = code_range_fault(out, Q)
        if bad is not None:
            print(range_fail(f"carried launch resumed at t0={RESUME_T0}, "
                             f"B={batch} T={temperature}, {what}", bad, Q))
            return False, float("inf"), gen, carry, lc_r
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
    what = f"primed kernel (P={P}, n={n}) B={batch} gc={gc_ids} T={temperature}"
    bad = code_range_fault(free, Q)
    if bad is not None:
        print(range_fail(f"{what}, its unprimed seed launch", bad, Q))
        return {"ok": False, "gap": float("inf"), "ms": float("nan"),
                "plain_ms": float("nan"), "gen": gen}
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
    bad = code_range_fault(codes, Q)
    if bad is not None:
        print(range_fail(what, bad, Q))
        return {"ok": False, "gap": float("inf"), "ms": ms,
                "plain_ms": float("nan"), "gen": gen}
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
    ok = bool(np.isfinite(gap) and gap <= SCORE_TOL and same)
    print(f"{what}: max score gap vs plain {gap:.3g} (tol {SCORE_TOL}), kept codes == "
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
    """The CLIs on the card, from serving checkpoints written into
    ``tmp``: ``generate_wavenet`` primed from a seed wav (K3), then
    streamed (K4), then ``synthesize`` (Tacotron-2 + vocoder, K1), then
    ``eval --skip-harvard`` through the vocoder (8 sentences, K1). Returns
    (ok, launches of each form over these runs: one-shot, primed,
    carried)."""
    import contextlib
    import io
    import os

    from scipy.io import wavfile

    from nspeech_tpu_torch.cli import eval as eval_cli
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
    totals = [0, 0, 0]

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
        for i, c in enumerate(counters):
            totals[i] += c.launches
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

    eval_dir = os.path.join(tmp, "eval")
    wall, (one, primed, carried), out = run(eval_cli.main, [
        "--checkpoint", taco_dir, "--hparams", f"max_iters={MAX_ITERS}",
        "--vocoder-checkpoint", voc_dir, "--skip-harvard", "--output-dir",
        eval_dir])
    files = sorted(os.listdir(eval_dir))
    wavs = [f for f in files if f.endswith(".wav")]
    pngs = [f for f in files if f.endswith(".png")]
    sizes = [wavfile.read(os.path.join(eval_dir, f))[1].size for f in wavs]
    good = (len(wavs) == 8 and len(pngs) == 16 and one == 8
            and all(n > 0 for n in sizes))
    ok &= good
    print(f"cli eval --skip-harvard (vocoder): {wall:.3f} s wall, {len(wavs)} "
          f"wavs {sizes} samples, {len(pngs)} PNGs, launches one-shot {one} -> "
          f"{'ok' if good else 'FAIL'}")
    return ok, totals


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


def one_shot_mels(syn, texts, speakers, params=None, bn_state=None):
    """The model's forward mel for the ``Synthesizer``'s (and the
    stream's) padded batch: on the synthesizer's device and weights, or,
    given ``params`` and ``bn_state``, on theirs (the CPU reference)."""
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
    if params is None:
        params, bn_state, dev = syn._params, syn._bn_state, syn.device
    else:
        dev = params["embedding"]["table"].device
    out = syn.model.forward(params, bn_state, ids.to(dev), lengths.to(dev),
                            spk.to(dev))
    return out["mel_outputs"][: len(texts)].cpu().numpy()


def reset_launches():
    from nspeech_tpu_torch.ops.cuda import wavenet_gen

    for sampler in (wavenet_gen.SAMPLER, wavenet_gen.PRIMED_SAMPLER,
                    wavenet_gen.CARRIED_SAMPLER):
        sampler.launches = 0


def taco1_phase():
    """Tacotron-1 at its published widths through the serving path: two
    requests and a batch of 2 through ``TextToSpeech`` (K1/K2), one stream
    through ``StreamingTTS`` (K4), then the other five attention types
    through Griffin-Lim. Each mel is held to the CPU forward of the same
    weights (TACO_TOL); the stream at T=0 to ``vocode_batch`` of its own
    mel. Returns (ok, one-shot launches, carried launches)."""
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.attention import ATTENTION_TYPES
    from nspeech_tpu_torch.models.tacotron import Tacotron1
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.serving import (StreamingTTS, Synthesizer,
                                           TextToSpeech, WaveNetVocoder)

    cfg = load_config("taco1").parse(f"max_iters={MAX_ITERS}")
    print(f"taco1: published widths (r={cfg.outputs_per_step}, "
          f"{cfg.encoder_cbhg_banks}-bank encoder CBHG, {cfg.attention_type} "
          f"attention), max_iters={MAX_ITERS}, vocoder {VOCODER_HPARAMS}; mels "
          f"vs the CPU forward of the same weights (tol {TACO_TOL})")
    model = Tacotron1(cfg)
    params, bn = model.init(4)              # CPU tensors: the reference
    syn = Synthesizer(cfg).set_variables(params, bn, model=model)
    vcfg, net, vparams = vocoder(2)
    voc = WaveNetVocoder(vcfg).set_variables(net, vparams)
    tts = TextToSpeech(syn, voc)
    texts = ["Tacotron one speaks through the sampler.",
             "A second request on the card.",
             "Two texts share one batch.",
             "And one vocoder launch."]
    tts.synthesize(texts[0])                # warm-up: cuDNN plans
    torch.cuda.synchronize()

    def gap_to_cpu(mels, batch):
        ref = one_shot_mels(syn, batch, None, params, bn)
        return float(np.abs(np.asarray(mels)[:, : ref.shape[1]] - ref).max())

    ok = True
    reset_launches()
    for i, text in enumerate(texts[:2]):
        t0 = time.perf_counter()
        wav, mel, _ = tts.synthesize(text, temperature=1.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gap = gap_to_cpu(mel[None], [text])
        good = wav.size > 0 and bool(np.isfinite(wav).all()) and gap <= TACO_TOL
        ok &= good
        print(f"taco1 request {i}: {dt:.3f} s wall, mel {mel.shape}, wav "
              f"{wav.size} samples, mel vs CPU max |diff| {gap:.3g} -> "
              f"{'ok' if good else 'FAIL'}")
    t0 = time.perf_counter()
    wavs, mels, _ = tts.synthesize_batch(texts[2:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gap = gap_to_cpu(mels, texts[2:])
    good = (all(w.size > 0 and np.isfinite(w).all() for w in wavs)
            and gap <= TACO_TOL)
    ok &= good
    print(f"taco1 batch of 2: {dt:.3f} s wall, wav lengths "
          f"{[w.size for w in wavs]}, mel vs CPU max |diff| {gap:.3g} -> "
          f"{'ok' if good else 'FAIL'}")
    st = StreamingTTS(syn, voc, chunk_frames=40, temperature=0.0, growth=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, parts = None, []
    for chunk in st.stream(texts[0]):
        if first is None:
            first = time.perf_counter() - t0
        parts.append(chunk)
    wall = time.perf_counter() - t0
    one, carried = wavenet_gen.SAMPLER.launches, wavenet_gen.CARRIED_SAMPLER.launches
    wav = np.concatenate(parts)
    ref = voc.vocode_batch(st.last_mel_batch, None, temperature=0.0)[0]
    equal = (np.array_equal(wav, ref[: wav.size])
             and wav.size == st.last_total_frames * st._hop)
    gap = gap_to_cpu(st.last_mel[None], texts[:1])
    good = equal and gap <= TACO_TOL and carried > 0
    ok &= good
    print(f"taco1 stream (T=0): time to first audio {first:.3f} s, wall "
          f"{wall:.3f} s, {len(parts)} chunks {[len(p) for p in parts]}, "
          f"equals vocode_batch of its mel {equal}, mel vs CPU max |diff| "
          f"{gap:.3g} -> {'ok' if good else 'FAIL'}")
    print(f"taco1 sampler launches: one-shot {one} (2 requests + 1 batch), "
          f"carried {carried}")
    if one != 3:
        print("FAIL: the taco1 requests did not launch the sampler once each")
        ok = False
    for att in ATTENTION_TYPES:
        if att == cfg.attention_type:
            continue
        acfg = load_config("taco1").parse(
            f"max_iters={MAX_ITERS},attention_type={att}")
        amodel = Tacotron1(acfg)
        aparams, abn = amodel.init(5)
        asyn = Synthesizer(acfg).set_variables(aparams, abn, model=amodel)
        t0 = time.perf_counter()
        wav, mel, _ = asyn.synthesize(texts[1])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref = one_shot_mels(asyn, texts[1:2], None, aparams, abn)[0]
        gap = float(np.abs(mel - ref).max())
        good = (wav.size > 0 and bool(np.isfinite(wav).all())
                and bool(np.isfinite(mel).all()) and gap <= TACO_TOL)
        ok &= good
        print(f"taco1 {att} (Griffin-Lim): {dt:.3f} s wall, wav {wav.size} "
              f"samples, mel vs CPU max |diff| {gap:.3g} -> "
              f"{'ok' if good else 'FAIL'}")
    return ok, one, carried


def server_phase():
    """The port's demo server on a local port, over the full-width
    Tacotron-2 + vocoder, with a DynamicBatcher (8, 50 ms) and a
    StreamBatcher (4, 50 ms): 8 concurrent /synthesize, 4 concurrent
    /synthesize_stream, one /synthesize_batch of 3, one long-form text
    through the batcher, then /stats. Returns (ok, one-shot launches,
    carried launches)."""
    import io
    import threading
    import urllib.error
    import urllib.request
    import zipfile
    from types import SimpleNamespace
    from urllib.parse import quote

    from scipy.io import wavfile

    from nspeech_tpu_torch.cli import demo_server
    from nspeech_tpu_torch.config import load_config, stft_params
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.serving import (DynamicBatcher, StreamBatcher,
                                           StreamingTTS, Synthesizer,
                                           TextToSpeech, WaveNetVocoder,
                                           synthesize_long)

    cfg = load_config("taco2").parse(f"max_iters={MAX_ITERS}")
    hop = stft_params(cfg)[1]
    full = MAX_ITERS * cfg.outputs_per_step * hop   # a decode that never stops
    model = Tacotron2(cfg)
    params, bn = model.init(1)
    syn = Synthesizer(cfg).set_variables(params, bn, model=model)
    vcfg, net, vparams = vocoder(2)
    voc = WaveNetVocoder(vcfg).set_variables(net, vparams)
    vocoded = []                      # (streams, samples, seconds) per call
    vocode_batch = voc.vocode_batch

    def timed_vocode_batch(mels, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = vocode_batch(mels, *args, **kwargs)   # ends in a device->host copy
        vocoded.append((out.shape[0], out.shape[1], time.perf_counter() - t0))
        return out

    voc.vocode_batch = timed_vocode_batch
    batcher = DynamicBatcher(TextToSpeech(syn, voc), max_batch=8, window_ms=50)
    streams = StreamBatcher(StreamingTTS(syn, voc, chunk_frames=40),
                            max_batch=4, window_ms=50)
    print(f"server: taco2 full width, max_iters={MAX_ITERS}, vocoder "
          f"{VOCODER_HPARAMS}, DynamicBatcher(8, 50 ms), StreamBatcher(4, 50 ms)")
    t0 = time.perf_counter()
    demo_server._warmup(batcher, streams, SimpleNamespace(dynamic_batch=8))
    print(f"server warmup: {time.perf_counter() - t0:.3f} s")
    vocoded.clear()
    server = demo_server.make_server(
        demo_server.make_app(batcher, cfg, streamer=streams), 0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"

    def concurrent(n, fn):
        barrier = threading.Barrier(n)
        out = [None] * n

        def one(i):
            barrier.wait()
            try:
                out[i] = fn(i)
            except Exception as e:      # noqa: BLE001 - checked below
                out[i] = e

        threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return out

    texts = ["Request number %d reaches the batcher." % i for i in range(8)]

    def synth(i):
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"{base}/synthesize?text={quote(texts[i])}",
                                    timeout=600) as r:
            status, body = r.status, r.read()
        sr, wav = wavfile.read(io.BytesIO(body))
        return status, sr, wav.size, len(body), time.perf_counter() - t0

    def stream(i):
        t0 = time.perf_counter()
        with urllib.request.urlopen(
                f"{base}/synthesize_stream?text={quote(texts[i])}", timeout=600) as r:
            status, header = r.status, r.read(44)
            first = r.read(2)
            ttfb = time.perf_counter() - t0
            rest = r.read()
        return status, header, (len(first) + len(rest)) // 2, ttfb,             time.perf_counter() - t0

    ok = True
    try:
        # one request first: the HTTP client's and handler's modules load
        # on first use (under the import lock), which would otherwise
        # spread the concurrent requests' arrival past the window
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            page = r.status == 200 and b"<!doctype html>" in r.read()
        ok &= page
        print(f"server GET /: page {page}")
        reset_launches()
        got = concurrent(8, synth)
        for i, g in enumerate(got):
            good = (not isinstance(g, Exception) and g[0] == 200
                    and g[1] == cfg.sample_rate and 0 < g[2] <= full
                    and g[3] == 44 + 2 * g[2])
            ok &= good
            print(f"server /synthesize {i}: "
                  + (f"{g[4]:.3f} s wall, status {g[0]}, wav {g[2]} samples"
                     if not isinstance(g, Exception) else f"error {g!r}")
                  + f" -> {'ok' if good else 'FAIL'}")
        got = concurrent(4, stream)
        for i, g in enumerate(got):
            good = (not isinstance(g, Exception) and g[0] == 200
                    and g[1][:4] == b"RIFF" and g[1][8:12] == b"WAVE"
                    and g[2] == full)
            ok &= good
            print(f"server /synthesize_stream {i}: "
                  + (f"time to first audio {g[3]:.3f} s, wall {g[4]:.3f} s, "
                     f"{g[2]} samples" if not isinstance(g, Exception)
                     else f"error {g!r}")
                  + f" -> {'ok' if good else 'FAIL'}")
        t0 = time.perf_counter()
        req = urllib.request.Request(
            base + "/synthesize_batch", method="POST",
            data=json.dumps({"texts": texts[:3]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, r.read()
        zf = zipfile.ZipFile(io.BytesIO(body))
        sizes = [wavfile.read(io.BytesIO(zf.read(n)))[1].size for n in zf.namelist()]
        good = (status == 200 and zf.namelist() == ["utt_000.wav", "utt_001.wav",
                                                    "utt_002.wav"]
                and all(0 < n <= full for n in sizes))
        ok &= good
        print(f"server /synthesize_batch of 3: {time.perf_counter() - t0:.3f} s "
              f"wall, wavs {sizes} samples -> {'ok' if good else 'FAIL'}")
        t0 = time.perf_counter()
        wav = synthesize_long(batcher, "Long form in three pieces. Each one a "
                              "sentence. They share one batch.", pause_ms=150)
        good = wav.size > 2 * int(0.15 * cfg.sample_rate) and bool(np.isfinite(wav).all())
        ok &= good
        print(f"server synthesize_long (3 sentences, via the batcher): "
              f"{time.perf_counter() - t0:.3f} s wall, {wav.size} samples -> "
              f"{'ok' if good else 'FAIL'}")
        one = wavenet_gen.SAMPLER.launches
        carried = wavenet_gen.CARRIED_SAMPLER.launches
        try:
            urllib.request.urlopen(f"{base}/synthesize?text=hi&speaker_id=abc",
                                   timeout=60)
            bad = None
        except urllib.error.HTTPError as e:
            bad = e.code
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        streams.close()
    dyn = stats["dynamic_batching"]["max_batch_seen"]
    strm = stats["stream_batching"]["max_batch_seen"]
    good = bad == 400 and dyn >= 2 and strm >= 2 and one < 10 and carried < 4
    ok &= good
    calls = [(n, s, round(t, 3)) for n, s, t in vocoded]
    print(f"server: speaker_id=abc -> {bad}; /stats max_batch_seen dynamic "
          f"{dyn}, stream {strm}; sampler launches one-shot {one} for 10 "
          f"requests (8 + batch + long-form), carried {carried} for 4 streams; "
          f"vocoder calls (streams, samples, s) {calls} -> "
          f"{'ok' if good else 'FAIL'}")
    return ok, one, carried


def write_corpus(out_dir: str, n: int = TRAIN_UTTS, sr: int = 20000,
                 seed: int = 11) -> str:
    """A synthetic LJSpeech-layout corpus: ``n`` utterances of 1-10 s
    (sines with an AM envelope and a little noise), each with a text of
    about TEXT_RATE characters per second of audio joined from the Harvard
    sentences."""
    import os
    import re

    from scipy.io import wavfile

    import nspeech_tpu_torch

    path = os.path.join(os.path.dirname(nspeech_tpu_torch.__file__),
                        "harvard_sentences.txt")
    with open(path, encoding="utf-8") as f:
        sentences = [m.group(1) for m in
                     (re.match(r"\d+\.\d+ (.+)", line.strip()) for line in f) if m]
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    lines, k = [], 0
    for i in range(n):
        dur = 1.0 + 9.0 * i / (n - 1)
        t = np.arange(int(sr * dur)) / sr
        freq = 120.0 + 25.0 * (i % 12)
        wav = 0.45 * np.sin(2 * np.pi * freq * t)
        wav += 0.18 * np.sin(2 * np.pi * 3 * freq * t)
        wav *= 0.6 + 0.4 * np.sin(2 * np.pi * 2.0 * t)
        wav += 0.01 * rng.standard_normal(len(t))
        wavfile.write(os.path.join(out_dir, "wavs", "SYN%03d.wav" % i), sr,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        text = ""
        while len(text) < TEXT_RATE * dur:
            text = (text + " " + sentences[k % len(sentences)]).strip()
            k += 1
        text = text[: int(TEXT_RATE * dur)].rstrip()
        lines.append(f"SYN{i:03d}|{text}|{text}")
    with open(os.path.join(out_dir, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return out_dir


def random_batch(seed: int, rows: int = 4):
    """A feeder batch of ``rows`` with random symbol ids and random targets
    in [0, 1): 40/33/25/12 symbols, 100/80/64/31 frames of T_out 105 (in
    turns), zero past each row's frames."""
    from nspeech_tpu_torch.data.feeder import Batch

    rng = np.random.default_rng(seed)
    lengths = np.resize([40, 33, 25, 12], rows)
    frames = np.resize([100, 80, 64, 31], rows)
    ids = rng.integers(2, 60, (rows, 40))
    ids[np.arange(40)[None] >= lengths[:, None]] = 0
    mel = rng.random((rows, 105, 80), dtype=np.float32)
    lin = rng.random((rows, 105, 1025), dtype=np.float32)
    mel[np.arange(105)[None] >= frames[:, None]] = 0.0
    lin[np.arange(105)[None] >= frames[:, None]] = 0.0
    return Batch(ids, lengths, np.zeros(rows, np.int64), mel, lin,
                 np.zeros((rows, 0), np.float32))


def leaf_gaps(ref, got) -> dict:
    """Per leaf (dicts by path): the largest entry of ``got - ref`` over
    the largest entry of ``ref``. A conv bias that feeds batch norm has a
    gradient that cancels to ~0: it is measured against its conv kernel's
    gradient."""
    out = {}
    for path, r in ref.items():
        base = ref[path[:-4] + "kernel"] if path.endswith("/conv/bias") else r
        err = (got[path].cpu().double() - r.cpu().double()).abs().max()
        out[path] = (err / base.abs().max().clamp(min=1e-300)).item()
    return out


def grad_gap(ref, got) -> float:
    """The worst leaf of ``leaf_gaps``."""
    return max(leaf_gaps(ref, got).values())


def to_float64(state, batch):
    """A train state and a device batch with float64 parameters, batch
    norm statistics and targets."""
    from nspeech_tpu_torch.utils.tree import tree_map

    return (state._replace(params=tree_map(torch.Tensor.double, state.params),
                           bn_state=tree_map(torch.Tensor.double, state.bn_state)),
            batch._replace(mel_targets=batch.mel_targets.double(),
                           linear_targets=batch.linear_targets.double()))


def rel_err(ref, got):
    """2-norm of ``got - ref`` over the 2-norm of ``ref``: trees (dicts by
    path) or numbers."""
    if not isinstance(ref, dict):
        return abs(got - ref) / abs(ref)
    err = sum(torch.sum((got[p].cpu().double() - r.cpu().double()) ** 2)
              for p, r in ref.items())
    return torch.sqrt(err / sum(torch.sum(r.cpu().double() ** 2)
                                for r in ref.values())).item()


def card_vs_cpu_step(batch) -> dict:
    """One Tacotron-2 training step at the published widths (no dropout,
    an EMA of decay 0.999) from the same state on the card and on the CPU,
    on ``batch`` (a feeder batch). Returns the readings that
    ``step_agreement`` holds to their bounds:

    - ``loss``, ``grad_norm``, ``update``, ``ema``: from
      ``build_tacotron_train_step`` (the trainer's clip, Adam and EMA) in
      float32: the loss, the ``grad_norm`` metric, and the 2-norms of the
      parameters' move and of the EMA's move, each relative to the CPU's;
    - ``grads``: the float32 gradient (``tacotron_grads``), as a whole,
      relative to the CPU's in 2-norm;
    - ``leaf32``: its worst leaf (``grad_gap``), reported: a relu or an
      L1 residual whose input lies within float32 rounding of 0 passes or
      stops its gradient on one device and not on the other, and moves
      single entries of a few leaves by up to some 1e-2 of their largest;
    - ``leaf64``: the worst leaf of the gradient computed in float64 on
      both devices, where no such input is that close to 0."""
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.train.loop import (batch_to_device,
                                              build_tacotron_train_step,
                                              create_state, tacotron_grads)
    from nspeech_tpu_torch.train.optim import make_optimizer
    from nspeech_tpu_torch.utils.tree import named_leaves

    cfg = load_config("taco2").parse("drop_rate=0.0,ema_decay=0.999")
    model = Tacotron2(cfg)
    opt, sched = make_optimizer(cfg, "taco2")
    step = build_tacotron_train_step(model, opt, sched, cfg.ema_decay)
    def move(tree, old):        # 2-norm of tree - old
        return torch.sqrt(sum(torch.sum((x - old[p]).double() ** 2)
                              for p, x in named_leaves(tree))).item()

    out = {}
    for dev in ("cpu", "cuda"):
        state = create_state(model, opt, 0, ema=True, device=dev)
        data = batch_to_device(batch, dev)
        t0 = time.perf_counter()
        grads = dict(named_leaves(tacotron_grads(model, state, data, None)[0]))
        new, m = step(state, data, None)
        old = dict(named_leaves(state.params))
        out[dev] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "grads": grads,
                    "update": move(new.params, old), "ema": move(new.ema_params, old),
                    "s": time.perf_counter() - t0}
        torch.set_default_dtype(torch.float64)    # the decoder's zero carries too
        try:
            out[dev]["grads64"] = dict(named_leaves(
                tacotron_grads(model, *to_float64(state, data), None)[0]))
        finally:
            torch.set_default_dtype(torch.float32)
    cpu, card = out["cpu"], out["cuda"]
    r = {k: rel_err(cpu[k], card[k])
         for k in ("loss", "grad_norm", "grads", "update", "ema")}
    r.update(leaf32=grad_gap(cpu["grads"], card["grads"]),
             leaf64=grad_gap(cpu["grads64"], card["grads64"]),
             loss_cpu=cpu["loss"], loss_card=card["loss"], cpu_s=cpu["s"],
             card_s=card["s"], T_out=batch.mel_targets.shape[1])
    return r


def step_agreement(r) -> tuple:
    """(ok, line) for the readings of ``card_vs_cpu_step``."""
    ok = (r["loss"] <= STEP_LOSS_TOL and r["leaf64"] <= STEP_GRAD_TOL
          and max(r["grad_norm"], r["grads"], r["update"], r["ema"]) <= STEP_NORM_TOL
          and r["leaf32"] <= STEP_LEAF_TOL)
    return ok, (
        f"loss {r['loss_card']:.7f} vs {r['loss_cpu']:.7f} (rel {r['loss']:.2e}, "
        f"tol {STEP_LOSS_TOL}); float64 gradients: worst leaf {r['leaf64']:.2e} of "
        f"its largest entry (tol {STEP_GRAD_TOL}); float32, relative in 2-norm (tol "
        f"{STEP_NORM_TOL}): gradient {r['grads']:.2e}, grad_norm {r['grad_norm']:.2e}, "
        f"Adam's update {r['update']:.2e}, EMA's move {r['ema']:.2e}; float32 worst "
        f"leaf {r['leaf32']:.2e} (tol {STEP_LEAF_TOL}); step and float32 gradient "
        f"cpu {r['cpu_s']:.2f} s, card {r['card_s']:.2f} s (first call)")


def deferred_vs_autograd(batch) -> float:
    """The worst leaf (``grad_gap``) of one Tacotron-2 step's float64
    gradient on the card, published widths, no dropout, with the loops'
    weight gradients deferred against all of them from autograd."""
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.train.loop import (batch_to_device, create_state,
                                              tacotron_grads)
    from nspeech_tpu_torch.train.optim import make_optimizer
    from nspeech_tpu_torch.utils.tree import named_leaves

    cfg = load_config("taco2").parse("drop_rate=0.0")
    model = Tacotron2(cfg)
    state = create_state(model, make_optimizer(cfg, "taco2")[0], 0, device="cuda")
    grads = {}
    torch.set_default_dtype(torch.float64)        # the decoder's zero carries too
    try:
        state, data = to_float64(state, batch_to_device(batch, "cuda"))
        for deferred in (False, True):
            grads[deferred] = dict(named_leaves(tacotron_grads(
                model, state, data, None, deferred_dw=deferred)[0]))
    finally:
        torch.set_default_dtype(torch.float32)
    return grad_gap(grads[False], grads[True])


def deferred_timing(corpus: str, tmp: str, card: str) -> None:
    """Tacotron-2 at batch 32 on the corpus's longest padded batch (T_out
    900), weight gradients by autograd (A) and deferred (D): warm sec/step
    in turns A, D, D, A (TURN_STEPS timed steps after one untimed step
    each) with each turn's peak memory; then one step of each, on the
    batch padded to PROFILE_T_OUT frames, under
    ``torch.profiler`` (``scripts/torch_train_profile.py --profile-only``'s
    ``profile_step``): launches, kernel time, busy share and
    ``aten::add_``'s share of the kernel time, with its costliest input
    shapes."""
    import os
    import statistics

    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.data.feeder import DataFeeder
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.train.loop import (batch_to_device,
                                              build_tacotron_train_step,
                                              create_state, step_generator)
    from nspeech_tpu_torch.train.optim import make_optimizer

    cfg = load_config("taco2")
    cache = os.path.join(tmp, "features")
    longest = max(DataFeeder({"ljspeech": corpus}, cfg, seed=0,
                             cache_dir=cache).epoch_batches(0),
                  key=lambda b: b.mel_targets.shape[1])
    data = batch_to_device(longest, "cuda")
    model = Tacotron2(cfg)
    opt, sched = make_optimizer(cfg, "taco2")
    steps = {d: build_tacotron_train_step(model, opt, sched, deferred_dw=d)
             for d in (False, True)}
    state = create_state(model, opt, 0, device="cuda")
    times, peaks = {False: [], True: []}, {False: 0, True: 0}
    for d in (False, True, True, False):
        torch.cuda.reset_peak_memory_stats()
        for i in range(1 + TURN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steps[d](state, data, step_generator("cuda", 0, state.step))
            float(m["loss"])
            if i:
                times[d].append(time.perf_counter() - t0)
        peaks[d] = max(peaks[d], torch.cuda.max_memory_allocated())
    del state
    label = {False: "autograd", True: "deferred"}
    print(f"train taco2 weight gradients, warm sec/step at batch 32, T_out "
          f"{data.mel_targets.shape[1]} in turns autograd, deferred, deferred, "
          f"autograd: " + "; ".join(
              f"{label[d]} median {statistics.median(times[d]):.4f} s of "
              f"({', '.join(f'{x:.4f}' for x in times[d])}), peak "
              f"{peaks[d] / 2**30:.2f} GiB" for d in (False, True)) + f" [{card}]")
    prof = repo_module("scripts/torch_train_profile.py")
    rows = []
    for d in (False, True):
        # the profiler's cost grows with the step's ~75,000 launches at
        # T_out 900: the profiled steps run the T_out PROFILE_T_OUT batch,
        # and write no Chrome trace (nothing here reads one)
        r = prof.profile_step(corpus, "", None, deferred_dw=d, tables=False,
                              cache_dir=cache, t_out=PROFILE_T_OUT)
        rows.append(f"{label[d]} {r['launches']} launches, kernels "
                    f"{r['busy_ms']:.1f} ms ({r['busy_ms'] / r['step_ms']:.1%} of "
                    f"the {r['step_ms']:.1f} ms step), aten::add_ {r['add_ms']:.1f} ms "
                    f"in {r['add_calls']} calls ({r['add_ms'] / max(r['busy_ms'], 1e-9):.1%} "
                    f"of the kernel time)")
    print("train taco2 profiled step (scripts/torch_train_profile.py "
          f"--profile-only's profile_step, T_out {PROFILE_T_OUT}): "
          + "; ".join(rows) + f" [{card}]")


def train_phase(tmp: str):
    """Training on the card: the train CLI (``cli.train``, Tacotron-2 at
    the published widths, batch 32, drop_rate 0.5) on a synthetic corpus
    for TRAIN_STEPS steps with checkpoints every 2, a second run resumed to
    step TRAIN_STEPS + 1, one training step on the card against the same
    step on the CPU, ``cli.synthesize`` from the trained checkpoint through
    the sampler (K1), and Tacotron-1 for 2 steps. Returns (ok, one-shot
    launches)."""
    import contextlib
    import io
    import os
    import re
    import statistics

    from scipy.io import wavfile

    from nspeech_tpu_torch.cli import synthesize
    from nspeech_tpu_torch.cli import train as train_cli
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.data.corpus import load_items
    from nspeech_tpu_torch.data.features import build_from_paths
    from nspeech_tpu_torch.data.feeder import DataFeeder
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.train.loop import (batch_to_device,
                                              build_tacotron_train_step,
                                              create_state, step_generator)
    from nspeech_tpu_torch.train.optim import make_optimizer

    card = card_line()
    ok = True
    corpus = write_corpus(os.path.join(tmp, "corpus"))
    cache = os.path.join(tmp, "features")
    logs = os.path.join(tmp, "logs")
    items = load_items({"ljspeech": corpus})
    cfg = load_config("taco2")
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 1))   # as the CLI
    t0 = time.perf_counter()
    utts = build_from_paths([it[0] for it in items], cfg, cache)
    feat_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    audio_s = sum(len(u.wav) for u in utts) / cfg.sample_rate
    print(f"train featurize: {len(utts)} utterances, {audio_s:.1f} s of audio "
          f"in {feat_s:.3f} s on the host CPU ({feat_s / len(utts) * 1e3:.1f} ms "
          f"per utterance, {audio_s / feat_s:.0f} audio s per s) [{card}]")

    step_times = []
    real_build = train_cli.build_tacotron_train_step

    def timed_build(*args, **kwargs):
        step_fn = real_build(*args, **kwargs)

        def timed(state, batch, generator):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(state, batch, generator)
            torch.cuda.synchronize()
            step_times.append((time.perf_counter() - t0,
                               tuple(batch.mel_targets.shape),
                               tuple(batch.inputs.shape)))
            return out

        return timed

    def run_train(argv):
        out = io.StringIO()
        step_times.clear()
        torch.cuda.reset_peak_memory_stats()
        train_cli.build_tacotron_train_step = timed_build
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                train_cli.main(argv)
        finally:
            train_cli.build_tacotron_train_step = real_build
        wall = time.perf_counter() - t0
        text = out.getvalue()
        for line in text.splitlines():
            if not line.startswith("  "):      # the hparams dump
                print("  |", line)
        losses = [float(x) for x in re.findall(r"loss=([-0-9.naninf]+),", text)]
        return text, wall, losses, torch.cuda.max_memory_allocated()

    base = ["--ljspeech", corpus, "--log-dir", logs, "--cache-dir", cache,
            "--checkpoint-interval", "2", "--seed", "0"]
    text, wall, losses, peak = run_train(
        base + ["--model", "taco2", "--max-steps", str(TRAIN_STEPS)])
    FIRST_LOSS["taco2"] = losses[0] if losses else float("nan")
    ckpt = os.path.join(logs, "taco2", "ckpt")
    files = [os.path.join(ckpt, f) for f in
             ("train/2.pt", f"train/{TRAIN_STEPS}.pt",
              f"serving/{TRAIN_STEPS}.npz", "config.json")]
    good = (len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
            and all(os.path.exists(f) for f in files))
    ok &= good
    for i, (sec, mel_shape, in_shape) in enumerate(step_times):
        print(f"train taco2 step {i + 1}: {sec:.4f} s, loss {losses[i]:.5f}, "
              f"batch {mel_shape[0]}, T_in {in_shape[1]}, T_out {mel_shape[1]} "
              f"[{card}]")
    sec_step = statistics.median(t for t, _, _ in step_times[1:])
    print(f"train taco2 (published widths, batch {cfg.batch_size}): sec/step "
          f"{sec_step:.4f} (median of steps 2-{TRAIN_STEPS}, which hold the first "
          f"step at the second padded length), peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated), {wall:.1f} s wall "
          f"for the run; checkpoints {'ok' if good else 'FAIL'} [{card}]")

    text, wall, losses, _ = run_train(
        base + ["--model", "taco2", "--max-steps", str(TRAIN_STEPS + 1)])
    good = (f"Resumed from checkpoint step {TRAIN_STEPS}" in text
            and len(losses) == 1 and np.isfinite(losses[0])
            and os.path.exists(os.path.join(ckpt, f"train/{TRAIN_STEPS + 1}.pt")))
    ok &= good
    print(f"train taco2 resume: step {TRAIN_STEPS} -> {TRAIN_STEPS + 1}, loss "
          f"{losses[0] if losses else float('nan'):.5f}, "
          f"{step_times[0][0] if step_times else float('nan'):.4f} s for the "
          f"step, {wall:.1f} s wall -> {'ok' if good else 'FAIL'} [{card}]")

    # warm sec/step per padded length: the CLI's steps alternate two
    # shapes, and the first step at each plans cuDNN and grows the cache
    tcfg = load_config("taco2")
    shapes = {}
    for b in DataFeeder(items, tcfg, cache_dir=cache).epoch_batches(0):
        shapes.setdefault(b.mel_targets.shape[1], batch_to_device(b, "cuda"))
    model = Tacotron2(tcfg)
    opt, sched = make_optimizer(tcfg, "taco2")
    state = create_state(model, opt, 0, device="cuda")
    step_fn = build_tacotron_train_step(model, opt, sched)
    warm = {}
    for t_out, data in sorted(shapes.items()):
        for i in range(1 + WARM_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, data, step_generator("cuda", 0, state.step))
            float(m["loss"])
            if i:
                warm.setdefault(t_out, []).append(time.perf_counter() - t0)
    del state, shapes
    print("train taco2 warm steps (batch 32, after one step at each shape): " + "; ".join(
        f"T_out {t}: median {statistics.median(v):.4f} s of {len(v)} "
        f"({', '.join(f'{x:.4f}' for x in v)})" for t, v in warm.items()) + f" [{card}]")

    # one step on the card against the same step on the CPU: the 4
    # shortest utterances, published widths, no dropout
    scfg = load_config("taco2").parse("batch_size=4,batch_group_size=1")
    batch = next(DataFeeder(items[:4], scfg, cache_dir=cache).epoch_batches(0))
    t0 = time.perf_counter()
    good, line = step_agreement(card_vs_cpu_step(batch))
    line += f"; {time.perf_counter() - t0:.1f} s for the comparison"
    ok &= good
    print(f"train step cuda vs cpu (4 utterances, T_out {batch.mel_targets.shape[1]}, "
          f"weight gradients deferred): {line} -> {'ok' if good else 'FAIL'} [{card}]")
    gap = deferred_vs_autograd(batch)
    good = gap <= STEP_GRAD_TOL
    ok &= good
    print(f"train step deferred vs autograd weight gradients on the card (4 "
          f"utterances, float64): worst leaf {gap:.2e} of its largest entry "
          f"(tol {STEP_GRAD_TOL}) -> {'ok' if good else 'FAIL'} [{card}]")
    t0 = time.perf_counter()
    deferred_timing(corpus, tmp, card)
    print(f"train deferred_timing: {time.perf_counter() - t0:.1f} s (turns and "
          f"both profiled steps)")

    reset_launches()
    out_wav = os.path.join(tmp, "trained.wav")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        synthesize.main(["--checkpoint", ckpt, "--hparams", f"max_iters={MAX_ITERS}",
                         "--vocoder-checkpoint", os.path.join(tmp, "vocoder"),
                         "--text", "Trained for five steps.", "--out", out_wav])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    one = wavenet_gen.SAMPLER.launches
    sr_out, wav = wavfile.read(out_wav)
    good = one >= 1 and wav.size > 0 and sr_out == cfg.sample_rate
    ok &= good
    print(f"cli synthesize from the trained taco2 (step {TRAIN_STEPS + 1}) "
          f"through the sampler: {wall:.3f} s wall, launches one-shot {one}; "
          f"wav {wav.size} samples -> {'ok' if good else 'FAIL'} [{card}]")

    text, wall, losses, peak = run_train(
        base + ["--model", "taco1", "--max-steps", "2"])
    good = (len(losses) == 2 and all(np.isfinite(losses)) and os.path.exists(
        os.path.join(logs, "taco1", "ckpt", "serving", "2.npz")))
    ok &= good
    times = ", ".join(f"{t:.4f} s (T_out {m[1]})" for t, m, _ in step_times)
    print(f"train taco1 (published widths, batch {cfg.batch_size}): steps {times}, "
          f"losses {losses}, peak memory {peak / 2**30:.2f} GiB, {wall:.1f} s "
          f"wall -> {'ok' if good else 'FAIL'} [{card}]")
    return ok, one


def wavenet_cfg(extra: str = ""):
    from nspeech_tpu_torch.config import load_config

    return load_config("wavenet").parse(WN_HPARAMS + extra)


def wavenet_card_vs_cpu(batch) -> dict:
    """One WaveNet step at the recipe's widths (gc table of 1 speaker, an
    EMA of decay 0.999) from the same state on the card and on the CPU, on
    ``batch`` (a ``WaveNetBatch`` of frame-rate mels). Returns the readings
    that ``wavenet_agreement`` holds to their bounds: from
    ``build_wavenet_train_step`` in float32 the loss, ``grad_norm`` and the
    2-norms of the parameters' and the EMA's moves, relative to the CPU's;
    the float32 gradient (``wavenet_grads``) relative in 2-norm
    (``grads``) and its worst leaf (``leaf32``; a post-net relu input
    within rounding of 0 moves single entries); and the worst leaf of the
    gradient in float64 on both devices (``leaf64``, the conditioning
    upsampled in float32 and then widened)."""
    from nspeech_tpu_torch.models.wavenet import WaveNet
    from nspeech_tpu_torch.ops.upsample import batch_lc
    from nspeech_tpu_torch.train.loop import (WaveNetDeviceBatch,
                                              build_wavenet_train_step,
                                              create_state, wavenet_batch_to_device,
                                              wavenet_grads)
    from nspeech_tpu_torch.train.optim import make_optimizer
    from nspeech_tpu_torch.utils.tree import named_leaves, tree_map

    cfg = wavenet_cfg(",gc_category_cardinality=1,ema_decay=0.999")
    net = WaveNet(cfg)
    opt, sched = make_optimizer(cfg, "wavenet")
    step = build_wavenet_train_step(net, opt, cfg, sched, use_gc=True,
                                    use_lc=True, ema_decay=cfg.ema_decay)

    def move(tree, old):        # 2-norm of tree - old
        return torch.sqrt(sum(torch.sum((x - old[p]).double() ** 2)
                              for p, x in named_leaves(tree))).item()

    out = {}
    for dev in ("cpu", "cuda"):
        state = create_state(net, opt, 0, ema=True, device=dev)
        data = wavenet_batch_to_device(batch, dev)
        t0 = time.perf_counter()
        grads = dict(named_leaves(wavenet_grads(net, state.params, data, cfg,
                                                True, True)[0]))
        new, m = step(state, data)
        old = dict(named_leaves(state.params))
        out[dev] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "grads": grads, "update": move(new.params, old),
                    "ema": move(new.ema_params, old), "s": time.perf_counter() - t0}
        data64 = WaveNetDeviceBatch(data.audio.double(), data.speaker_ids,
                                    batch_lc(data, cfg).double(), None)
        out[dev]["grads64"] = dict(named_leaves(wavenet_grads(
            net, tree_map(torch.Tensor.double, state.params), data64, cfg,
            True, True)[0]))
    cpu, card = out["cpu"], out["cuda"]
    r = {k: rel_err(cpu[k], card[k])
         for k in ("loss", "grad_norm", "grads", "update", "ema")}
    r.update(leaf32=grad_gap(cpu["grads"], card["grads"]),
             leaf64=grad_gap(cpu["grads64"], card["grads64"]),
             loss_cpu=cpu["loss"], loss_card=card["loss"], cpu_s=cpu["s"],
             card_s=card["s"])
    return r


def wavenet_agreement(r) -> tuple:
    """(ok, line) for the readings of ``wavenet_card_vs_cpu``."""
    ok = (r["loss"] <= WN_LOSS_TOL and r["leaf64"] <= WN_GRAD_TOL
          and max(r["grad_norm"], r["grads"], r["update"], r["ema"]) <= WN_NORM_TOL
          and r["leaf32"] <= WN_LEAF_TOL)
    return ok, (
        f"loss {r['loss_card']:.7f} vs {r['loss_cpu']:.7f} (rel {r['loss']:.2e}, "
        f"tol {WN_LOSS_TOL}); float64 gradients: worst leaf {r['leaf64']:.2e} of its "
        f"largest entry (tol {WN_GRAD_TOL}); float32, relative in 2-norm (tol "
        f"{WN_NORM_TOL}): gradient {r['grads']:.2e}, grad_norm {r['grad_norm']:.2e}, "
        f"Adam's update {r['update']:.2e}, EMA's move {r['ema']:.2e}; float32 worst "
        f"leaf {r['leaf32']:.2e} (tol {WN_LEAF_TOL}); step and float32 gradient cpu "
        f"{r['cpu_s']:.2f} s, card {r['card_s']:.2f} s (first call)")


def wavenet_train_phase(tmp: str):
    """The vocoder's training on the card, on ``train_phase``'s corpus and
    Tacotron-2 checkpoint (see the module's item 11). Returns (ok,
    one-shot launches of the generation from the fine-tuned vocoder)."""
    import contextlib
    import io
    import os
    import re
    import statistics

    from scipy.io import wavfile

    from nspeech_tpu_torch.cli import export_gta, generate_wavenet
    from nspeech_tpu_torch.cli import train as train_cli
    from nspeech_tpu_torch.cli import train_wavenet as wn_cli
    from nspeech_tpu_torch.config import stft_params
    from nspeech_tpu_torch.data.corpus import load_items
    from nspeech_tpu_torch.data.gta import fingerprint, gta_path, load_manifest
    from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder
    from nspeech_tpu_torch.dsp.trim import trim_silence
    from nspeech_tpu_torch.dsp.wavio import load_wav
    from nspeech_tpu_torch.models.wavenet import WaveNet
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.train.metadata import load_run_metadata

    card = card_line()
    phase_t0 = time.perf_counter()
    ok = True
    corpus = os.path.join(tmp, "corpus")
    logs = os.path.join(tmp, "logs")
    wn_ckpt = os.path.join(logs, "wavenet", "ckpt")
    cfg = wavenet_cfg()
    window = WaveNet(cfg).receptive_field + cfg.sample_size

    step_times = []
    real_build = wn_cli.build_wavenet_train_step

    def timed_build(*args, **kwargs):
        step_fn = real_build(*args, **kwargs)

        def timed(state, batch, generator=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(state, batch, generator)
            torch.cuda.synchronize()
            step_times.append(time.perf_counter() - t0)
            return out

        return timed

    def run_cli(main, argv, build=None):
        out = io.StringIO()
        step_times.clear()
        torch.cuda.reset_peak_memory_stats()
        if build is not None:
            wn_cli.build_wavenet_train_step = build
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                main(argv)
            torch.cuda.synchronize()
        finally:
            wn_cli.build_wavenet_train_step = real_build
        wall = time.perf_counter() - t0
        text = out.getvalue()
        for line in text.splitlines():
            if not line.startswith("  "):      # the hparams dump
                print("  |", line)
        losses = [float(x) for x in re.findall(r"loss=([-0-9.naninf]+),", text)]
        return text, wall, losses, torch.cuda.max_memory_allocated()

    base = ["--ljspeech", corpus, "--log-dir", logs, "--checkpoint-interval", "3",
            "--seed", "0"]
    text, wall, losses, peak = run_cli(
        wn_cli.main, base + ["--hparams", WN_HPARAMS, "--max-steps", str(WN_STEPS)],
        timed_build)
    FIRST_LOSS["wavenet"] = losses[0] if losses else float("nan")
    meta = load_run_metadata(wn_ckpt) or {}
    good = (len(losses) == WN_STEPS and all(np.isfinite(losses))
            and all(os.path.exists(os.path.join(wn_ckpt, f)) for f in
                    ("serving/3.npz", f"serving/{WN_STEPS}.npz", f"train/{WN_STEPS}.pt"))
            and meta.get("speaker_map") == [["ljspeech", "0", 0]]
            and meta["hparams"]["gc_category_cardinality"] == 1)
    ok &= good
    samples = cfg.batch_size * cfg.sample_size
    for i, sec in enumerate(step_times):
        print(f"train wavenet step {i + 1}: {sec:.4f} s, loss {losses[i]:.5f}, "
              f"batch {cfg.batch_size} windows of {window} samples [{card}]")
    sec_step = statistics.median(step_times[1:])
    print(f"train wavenet (recipe widths: 50 layers, R 32, S 512, Q 256, lc 80, gc "
          f"16; batch {cfg.batch_size} x {cfg.sample_size} samples): sec/step "
          f"{sec_step:.4f} (median of steps 2-{WN_STEPS}), {samples / sec_step:.0f} "
          f"audio samples per second, peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated), {wall:.1f} s wall for the run; checkpoints and "
          f"config.json {'ok' if good else 'FAIL'} [{card}]")

    text, wall, losses, _ = run_cli(
        wn_cli.main, base + ["--hparams", WN_HPARAMS, "--max-steps",
                             str(WN_STEPS + 1)], timed_build)
    good = (f"Resumed from checkpoint step {WN_STEPS}" in text and len(losses) == 1
            and np.isfinite(losses[0]) and os.path.exists(
                os.path.join(wn_ckpt, f"serving/{WN_STEPS + 1}.npz")))
    ok &= good
    print(f"train wavenet resume: step {WN_STEPS} -> {WN_STEPS + 1}, loss "
          f"{losses[0] if losses else float('nan'):.5f}, "
          f"{step_times[0] if step_times else float('nan'):.4f} s for the step, "
          f"{wall:.1f} s wall -> {'ok' if good else 'FAIL'} [{card}]")

    # the window feeder on the host: windows per second
    feeder = WaveNetFeeder({"ljspeech": corpus}, window - cfg.sample_size, cfg)
    stream = feeder.batches()
    t0 = time.perf_counter()
    n_feed = 8
    for _ in range(n_feed):
        next(stream)
    feed_s = time.perf_counter() - t0
    print(f"wavenet feeder: {n_feed} batches of {cfg.batch_size} windows in "
          f"{feed_s:.3f} s on the host CPU ({feed_s / n_feed * 1e3:.1f} ms per "
          f"batch) [{card}]")

    small = wavenet_cfg(f",batch_size=1,sample_size={WN_CHECK_WINDOW}")
    batch = next(WaveNetFeeder({"ljspeech": corpus}, window - cfg.sample_size,
                               small).batches())
    good, line = wavenet_agreement(wavenet_card_vs_cpu(batch))
    ok &= good
    print(f"train wavenet step cuda vs cpu (1 window of {batch.audio.shape[1]} "
          f"samples): {line} -> {'ok' if good else 'FAIL'} [{card}]")

    gta_dir = os.path.join(tmp, "gta")
    taco_ckpt = os.path.join(logs, "taco2", "ckpt")
    text, wall, _, _ = run_cli(export_gta.main, [
        "--checkpoint", taco_ckpt, "--ljspeech", corpus, "--out-dir", gta_dir])
    manifest = load_manifest(gta_dir)
    _, hop, _ = stft_params(cfg)
    rows = []
    for wav_path, _t, _s, _d in load_items({"ljspeech": corpus}):
        wav = trim_silence(load_wav(wav_path, cfg.sample_rate), cfg.silence_threshold)
        if wav.size:
            mel = np.load(gta_path(gta_dir, wav_path))
            rows.append(mel.shape[0] == 1 + len(wav) // hop
                        and bool(np.isfinite(mel).all()))
    taco_cfg = load_run_metadata(taco_ckpt)["hparams"]
    good = (len(rows) == manifest["count"] == len(manifest["files"]) and all(rows)
            and manifest["fingerprint"] == fingerprint(cfg)
            == {k: taco_cfg[k] for k in manifest["fingerprint"]})
    ok &= good
    print(f"cli export_gta from the trained taco2 over {len(rows)} utterances: "
          f"{wall:.3f} s wall, {manifest['count']} mels with 1 + trimmed // hop "
          f"rows, fingerprint equal to the config's -> {'ok' if good else 'FAIL'} "
          f"[{card}]")

    text, wall, losses, peak = run_cli(wn_cli.main, [
        "--ljspeech", corpus, "--log-dir", logs, "--gta-dir", gta_dir,
        "--hparams-from", wn_ckpt, "--max-steps", str(WN_STEPS + 3),
        "--checkpoint-interval", "3"], timed_build)
    good = (f"Resumed from checkpoint step {WN_STEPS + 1}" in text
            and "GTA mode" in text and len(losses) == 2
            and all(np.isfinite(losses)) and os.path.exists(
                os.path.join(wn_ckpt, f"serving/{WN_STEPS + 3}.npz")))
    ok &= good
    print(f"train wavenet on the GTA mels (--hparams-from, resumed at step "
          f"{WN_STEPS + 1}): steps {', '.join(f'{t:.4f} s' for t in step_times)}, "
          f"losses {losses}, {wall:.1f} s wall -> {'ok' if good else 'FAIL'} [{card}]")

    reset_launches()
    mel_path = os.path.join(gta_dir, sorted(manifest["files"].values())[0])
    out_wav = os.path.join(tmp, "gta_vocoded.wav")
    text, wall, _, _ = run_cli(generate_wavenet.main, [
        wn_ckpt, "--mel-npy", mel_path, "--gc-id", "0", "--samples",
        str(CLI_SAMPLES), "--wav_out_path", out_wav])
    one = wavenet_gen.SAMPLER.launches
    sr_out, wav = wavfile.read(out_wav)
    good = one >= 1 and wav.size == CLI_SAMPLES and sr_out == cfg.sample_rate
    ok &= good
    print(f"cli generate_wavenet from the GTA-tuned vocoder (step {WN_STEPS + 3}) "
          f"on an exported mel: {wall:.3f} s wall, launches one-shot {one}; wav "
          f"{wav.size} samples -> {'ok' if good else 'FAIL'} [{card}]")

    caches = []
    real_cache = train_cli.DeviceCachedBatches

    class Recorded(real_cache):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            caches.append(self)

    train_cli.DeviceCachedBatches = Recorded
    try:
        text, wall, losses, peak = run_cli(train_cli.main, [
            "--ljspeech", corpus, "--log-dir", logs, "--name", "taco2_cached",
            "--cache-dir", os.path.join(tmp, "features"), "--model", "taco2",
            "--device-cache", "2", "--max-steps", "2", "--checkpoint-interval", "2"])
    finally:
        train_cli.DeviceCachedBatches = real_cache
    cache = caches[0] if caches else None
    good = (cache is not None and len(losses) == 2 and all(np.isfinite(losses))
            and all(x.is_cuda for b in cache._batches for x in b)
            and "Device-cached" in text)
    ok &= good
    print(f"cli train --device-cache 2 (taco2, batch 32): "
          f"{cache.n_batches if cache else 0} batches of one shape on the card, "
          f"{cache.cached_mb if cache else 0:.0f} MB; losses {losses}, peak memory "
          f"{peak / 2**30:.2f} GiB, {wall:.1f} s wall -> {'ok' if good else 'FAIL'} "
          f"[{card}]")
    print(f"wavenet_train_phase took {time.perf_counter() - phase_t0:.1f} s")
    return ok, one


def precision_probe() -> dict:
    """What a float32 product runs under each ``--matmul-precision``: a
    [64, 256] @ [256, 64] product of entries 1 + 2^-9 + 2^-18 and ones is
    256.5009765625 in float32, 256.5 when the inputs are rounded to TF32
    (10 mantissa bits) and 256 when rounded to bf16 (7 bits)."""
    from nspeech_tpu_torch.ops.policy import MATMUL_PRECISIONS, set_matmul_precision

    a = torch.full((64, 256), 1 + 2 ** -9 + 2 ** -18, device="cuda")
    b = torch.ones(256, 64, device="cuda")
    names = {256.5009765625: "float32", 256.5: "tf32", 256.0: "bf16"}
    ran = {}
    for name in MATMUL_PRECISIONS:
        set_matmul_precision(name)
        v = float((a @ b)[0, 0])
        ran[name] = names.get(v, repr(v))
    set_matmul_precision("highest")
    return ran


def bf16_accumulation_check() -> tuple:
    """A bf16 GEMM at the skip product's contraction (K = 1,600) and a bf16
    cuDNN convolution at the postnet's shape (batch 32, 512 channels, 900
    frames, width 5) against the exact sum of the same bf16 operands: each
    output within one bf16 rounding of its exact value plus float32
    accumulation (2^-8 |exact| + 2^-16 sum|terms|). Returns (ok, line)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    ok = True
    a = torch.randn(2048, 1600, device="cuda", generator=g).bfloat16()
    w = torch.randn(1600, 512, device="cuda", generator=g).bfloat16()
    x = torch.randn(32, 512, 900, device="cuda", generator=g).bfloat16()
    k = torch.randn(512, 512, 5, device="cuda", generator=g).bfloat16() * 0.05
    for what, got, exact, mag in (
            ("gemm [2048, 1600] @ [1600, 512]", a @ w,
             a.double() @ w.double(), a.double().abs() @ w.double().abs()),
            ("conv1d [32, 512, 900] * [512, 512, 5]", F.conv1d(x, k, padding=2),
             F.conv1d(x.double(), k.double(), padding=2),
             F.conv1d(x.double().abs(), k.double().abs(), padding=2))):
        err = (got.double() - exact).abs()
        ratio = float((err / (2 ** -8 * exact.abs() + 2 ** -16 * mag)).max())
        good = got.dtype == torch.bfloat16 and ratio <= 1.0
        ok &= good
        out.append(f"{what}: worst error {ratio:.3f} of the bound")
    return ok, "; ".join(out)


def bf16_phase(tmp: str):
    """The bf16 compute policy on the card (``compute_dtype=bfloat16``),
    on ``train_phase``'s corpus. Returns (ok, one-shot launches of its
    requests, carried launches of its stream)."""
    import contextlib
    import io
    import os
    import re
    import statistics

    from nspeech_tpu_torch.cli import train as train_cli
    from nspeech_tpu_torch.cli import train_wavenet as wn_cli
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.data.corpus import load_items
    from nspeech_tpu_torch.data.feeder import DataFeeder
    from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.models.wavenet import WaveNet
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.models.tacotron import Tacotron1
    from nspeech_tpu_torch.serving import (StreamingTTS, Synthesizer,
                                           TextToSpeech, WaveNetVocoder)
    from nspeech_tpu_torch.train.loop import (batch_to_device,
                                              build_tacotron_train_step,
                                              build_wavenet_train_step,
                                              create_state, step_generator,
                                              wavenet_batch_to_device)
    from nspeech_tpu_torch.train.optim import make_optimizer
    from nspeech_tpu_torch.utils.tree import tree_leaves

    card = card_line()
    phase_t0 = time.perf_counter()
    ok = True
    corpus = os.path.join(tmp, "corpus")
    cache = os.path.join(tmp, "features")
    logs = os.path.join(tmp, "logs_bf16")
    items = load_items({"ljspeech": corpus})

    ran = precision_probe()
    good = ran["highest"] == "float32"
    ok &= good
    print(f"bf16 matmul precision: a float32 product ran {ran} -> "
          f"{'ok' if good else 'FAIL'} [{card}]")
    good, line = bf16_accumulation_check()
    ok &= good
    print(f"bf16 accumulation: {line} -> {'ok' if good else 'FAIL'} [{card}]")

    # teacher-forced Tacotron-2 at the published widths: bf16 against
    # float32 on the card, one feeder batch, the same seeded weights
    cfg32, cfg16 = load_config("taco2"), load_config("taco2").parse(BF16)
    batch = batch_to_device(next(DataFeeder(items, cfg32, cache_dir=cache)
                                 .epoch_batches(0)), "cuda")
    m32, m16 = Tacotron2(cfg32), Tacotron2(cfg16)
    state = create_state(m32, make_optimizer(cfg32, "taco2")[0], 0, device="cuda")
    mels = {}
    with torch.no_grad():
        for name, m in (("f32", m32), ("bf16", m16)):
            out, _ = m.forward_train(state.params, state.bn_state, batch.inputs,
                                     batch.input_lengths, batch.speaker_ids,
                                     batch.mel_targets, is_training=False)
            mels[name] = out["mel_outputs"]
    gap = (mels["bf16"].float() - mels["f32"]).abs()
    bound = BF16_MEL_TOL + BF16_MEL_TOL * mels["f32"].abs()
    good = (mels["bf16"].dtype == torch.bfloat16 and bool((gap <= bound).all()))
    ok &= good
    print(f"bf16 taco2 teacher-forced (batch {batch.inputs.shape[0]}, T_out "
          f"{batch.mel_targets.shape[1]}): mel max gap to float32 "
          f"{gap.max().item():.3e} (bound {BF16_MEL_TOL} + {BF16_MEL_TOL} |mel|) "
          f"-> {'ok' if good else 'FAIL'} [{card}]")
    del mels, state

    # two requests through TextToSpeech at bf16: float32 mels into the
    # sampler, one launch each
    scfg = load_config("taco2").parse(f"max_iters={MAX_ITERS}," + BF16)
    model = Tacotron2(scfg)
    syn = Synthesizer(scfg).set_variables(*model.init(1), model=model)
    vcfg, net, vparams = vocoder(2)
    tts = TextToSpeech(syn, WaveNetVocoder(vcfg).set_variables(net, vparams))
    tts.synthesize("Warm up the half precision path.")
    reset_launches()
    for i, text in enumerate(["Half precision serving on one card.",
                              "The sampler still reads float32 mels."]):
        before = wavenet_gen.SAMPLER.launches
        t0 = time.perf_counter()
        wav, mel, _ = tts.synthesize(text, temperature=1.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        good = (wavenet_gen.SAMPLER.launches - before == 1 and mel.dtype == np.float32
                and wav.size > 0 and bool(np.isfinite(wav).all()))
        ok &= good
        print(f"bf16 request {i}: {dt:.3f} s wall, mel {mel.shape} {mel.dtype}, "
              f"wav {wav.size} samples, sampler launches "
              f"{wavenet_gen.SAMPLER.launches - before} -> {'ok' if good else 'FAIL'} "
              f"[{card}]")
    # a bf16 stream (carried launches) and a bf16 Tacotron-1 request
    stream = StreamingTTS(syn, tts.vocoder, chunk_frames=40, growth=4)
    t0 = time.perf_counter()
    chunks = list(stream.stream("Half precision streams as well."))
    dt = time.perf_counter() - t0
    good = (wavenet_gen.CARRIED_SAMPLER.launches >= 1 and len(chunks) > 0
            and all(c.dtype == np.float32 and np.isfinite(c).all() for c in chunks))
    ok &= good
    print(f"bf16 stream (taco2): {dt:.3f} s wall, {len(chunks)} chunks, "
          f"{sum(c.size for c in chunks)} samples, carried launches "
          f"{wavenet_gen.CARRIED_SAMPLER.launches} -> {'ok' if good else 'FAIL'} "
          f"[{card}]")
    t1cfg = load_config("taco1").parse(f"max_iters={MAX_ITERS}," + BF16)
    taco1 = Tacotron1(t1cfg)
    tts1 = TextToSpeech(Synthesizer(t1cfg).set_variables(*taco1.init(3), model=taco1),
                        tts.vocoder)
    before = wavenet_gen.SAMPLER.launches
    t0 = time.perf_counter()
    wav, mel, _ = tts1.synthesize("Tacotron one in half precision.", temperature=1.0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    good = (wavenet_gen.SAMPLER.launches - before == 1 and mel.dtype == np.float32
            and wav.size > 0 and bool(np.isfinite(wav).all()))
    ok &= good
    print(f"bf16 taco1 request (cold): {dt:.3f} s wall, mel {mel.shape} {mel.dtype}, "
          f"wav {wav.size} samples -> {'ok' if good else 'FAIL'} [{card}]")
    launches = wavenet_gen.SAMPLER.launches
    carried = wavenet_gen.CARRIED_SAMPLER.launches
    del tts, tts1, syn, stream

    def run_cli(main, argv):
        out = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main(argv)
        torch.cuda.synchronize()
        text = out.getvalue()
        losses = [float(x) for x in re.findall(r"loss=([-0-9.naninf]+),", text)]
        return text, time.perf_counter() - t0, losses

    def masters_f32(ckpt, step):
        tree = torch.load(os.path.join(ckpt, "train", f"{step}.pt"), weights_only=True)
        return all(t.dtype == torch.float32 for key in ("params", "opt_state")
                   for t in tree_leaves(tree[key]) if isinstance(t, torch.Tensor)
                   and t.is_floating_point())

    base = ["--ljspeech", corpus, "--log-dir", logs, "--checkpoint-interval",
            str(BF16_STEPS), "--seed", "0", "--max-steps", str(BF16_STEPS)]
    for name, main, argv in (
            ("taco2", train_cli.main, ["--model", "taco2", "--cache-dir", cache,
                                       "--hparams", BF16]),
            ("wavenet", wn_cli.main, ["--hparams", WN_HPARAMS + "," + BF16])):
        text, wall, losses = run_cli(main, base + argv)
        ref = FIRST_LOSS.get(name, float("nan"))
        rel = abs(losses[0] - ref) / abs(ref) if losses else float("nan")
        good = (len(losses) == BF16_STEPS and all(np.isfinite(losses))
                and "compute dtype bfloat16" in text and rel <= BF16_LOSS_TOL
                and masters_f32(os.path.join(logs, name, "ckpt"), BF16_STEPS))
        ok &= good
        print(f"bf16 cli {name}: losses {losses}, the first {rel:.2e} relative from "
              f"the float32 run's first ({ref:.5f}, the same batch and init), "
              f"float32 masters and optimizer state in train/{BF16_STEPS}.pt, "
              f"{wall:.1f} s wall -> {'ok' if good else 'FAIL'} [{card}]")

    # peak memory of each dtype alone (its first step, the other's state
    # freed), then warm sec/step in turns float32, bf16, bf16, float32 (the
    # host's speed drifts within a call)
    def compare(label, make, data, gen, n):
        peaks, states = {}, {}
        for dtype in ("float32", "bf16"):
            step_fn, state = make(dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, m = step_fn(state, data, gen(state.step))
            float(m["loss"])
            peaks[dtype] = torch.cuda.max_memory_allocated()
            del state
        times = {"float32": [], "bf16": []}
        for dtype in ("float32", "bf16"):
            states[dtype] = make(dtype)
        for dtype in ("float32", "bf16", "bf16", "float32"):
            step_fn, state = states[dtype]
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step_fn(state, data, gen(state.step))
                float(m["loss"])
                times[dtype].append(time.perf_counter() - t0)
            states[dtype] = (step_fn, state)
        del states
        return "; ".join(
            f"{label} {d} {statistics.median(v):.4f} s "
            f"({', '.join(f'{x:.4f}' for x in v)}), peak {peaks[d] / 2**30:.2f} GiB"
            for d, v in times.items())

    def taco(dtype):
        cfg = cfg16 if dtype == "bf16" else cfg32
        model = Tacotron2(cfg)
        opt, sched = make_optimizer(cfg, "taco2")
        return (build_tacotron_train_step(model, opt, sched),
                create_state(model, opt, 0, device="cuda"))

    shapes = {}
    for b in DataFeeder(items, cfg32, cache_dir=cache).epoch_batches(0):
        shapes.setdefault(b.mel_targets.shape[1], batch_to_device(b, "cuda"))
    rows = [compare(f"taco2 T_out {t_out}", taco, data,
                    lambda s: step_generator("cuda", 0, s), WARM_STEPS)
            for t_out, data in sorted(shapes.items())]
    wcfg = {"float32": wavenet_cfg(",gc_category_cardinality=1"),
            "bf16": wavenet_cfg(",gc_category_cardinality=1," + BF16)}
    net = WaveNet(wcfg["float32"])
    wbatch = wavenet_batch_to_device(next(WaveNetFeeder(
        {"ljspeech": corpus}, net.receptive_field, wcfg["float32"]).batches()), "cuda")

    def wavenet(dtype):
        cfg = wcfg[dtype]
        net = WaveNet(cfg)
        opt, sched = make_optimizer(cfg, "wavenet")
        return (build_wavenet_train_step(net, opt, cfg, sched, use_gc=True,
                                         use_lc=True),
                create_state(net, opt, 0, device="cuda"))

    rows.append(compare(f"wavenet (batch {wcfg['bf16'].batch_size} x "
                        f"{wcfg['bf16'].sample_size})", wavenet, wbatch,
                        lambda s: None, 5))
    print("bf16 vs float32 warm sec/step (median of steps in turns float32, "
          "bf16, bf16, float32) and peak memory (each alone): "
          + "; ".join(rows) + f" [{card}]")
    print(f"bf16_phase took {time.perf_counter() - phase_t0:.1f} s")
    return ok, launches, carried


def import_phase(tmp: str):
    """Import of reference (TensorFlow) checkpoints at full width: the
    reference-named tensors of a seeded Tacotron-2 at its published widths
    and of the vocoder at the recipe (50 layers, R = DC = 32, S = 512,
    Q = 256, lc 80, gc 16, 4 speakers), as the ``{name: ndarray}`` mapping
    the importers take (this machine has no TensorFlow to write a bundle),
    through ``cli.import_reference_ckpt``'s ``import_checkpoint`` with the
    tree checked on the card; every imported leaf equal to its source;
    then one ``cli.synthesize`` request from the two imported checkpoints
    through the sampler (K1), and the imported Tacotron-2's served mel
    (``Synthesizer`` on the card) within MEL_TOL of the same checkpoint's
    forward on the CPU. Returns (ok, one-shot launches)."""
    import contextlib
    import io
    import os

    from scipy.io import wavfile

    from nspeech_tpu_torch.cli import synthesize
    from nspeech_tpu_torch.cli.import_reference_ckpt import import_checkpoint
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.serving import Synthesizer
    from nspeech_tpu_torch.train import load_serving_params
    from nspeech_tpu_torch.utils.tree import named_leaves

    card = card_line()
    names = repo_module("tests/make_reference_ckpt.py")
    model = Tacotron2(load_config("taco2"))
    params, bn = model.init(9)
    _, net, vparams = vocoder(10)
    sources = {"taco2": (names.taco2_names(params, bn), params),
               "wavenet": (names.wavenet_names(vparams), vparams)}
    ok, dirs = True, {}
    for name, (mapping, tree) in sources.items():
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dirs[name] = import_checkpoint(
                mapping, os.path.join(tmp, "imported_" + name), step=1000,
                device="cuda")
        wall = time.perf_counter() - t0
        model_of = model if name == "taco2" else net
        served = dict(named_leaves(load_serving_params(dirs[name], model_of)[0]))
        source = dict(named_leaves(tree))
        equal = served.keys() == source.keys() and all(
            torch.equal(served[k], source[k].cpu()) for k in source)
        ok &= equal
        print(f"import {name}: {len(mapping)} reference variables, "
              f"{sum(v.size for v in mapping.values()):,} values, "
              f"{buf.getvalue().splitlines()[-2]}; {wall:.2f} s; imported "
              f"leaves equal to the source {equal} -> "
              f"{'ok' if equal else 'FAIL'} [{card}]")
    text = "Imported weights speak through the sampler."
    reset_launches()
    out_wav = os.path.join(tmp, "imported.wav")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        synthesize.main(["--checkpoint", dirs["taco2"], "--hparams",
                         f"max_iters={MAX_ITERS}", "--vocoder-checkpoint",
                         dirs["wavenet"], "--text", text, "--out", out_wav])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    one = wavenet_gen.SAMPLER.launches
    sr, wav = wavfile.read(out_wav)
    syn = Synthesizer.from_checkpoint(dirs["taco2"], overrides=f"max_iters={MAX_ITERS}")
    _, mel, _ = syn.synthesize(text)
    cpu_params, cpu_bn = load_serving_params(dirs["taco2"], syn.model, device="cpu")
    ref = one_shot_mels(syn, [text], None, cpu_params, cpu_bn)[0]
    gap = float(np.abs(mel - ref[: mel.shape[0]]).max())
    good = (one == 1 and wav.size > 0 and sr == syn.cfg.sample_rate
            and gap <= MEL_TOL)
    ok &= good
    print(f"cli synthesize from the imported checkpoints through the sampler: "
          f"{wall:.3f} s wall, launches one-shot {one}, wav {wav.size} samples; "
          f"served mel {mel.shape} vs the CPU forward of the same checkpoint "
          f"max |diff| {gap:.3g} (tol {MEL_TOL}) -> {'ok' if good else 'FAIL'} "
          f"[{card}]")
    return ok, one


def export_phase(tmp: str):
    """Serving artifacts (``serving/export.py``) on the card: the
    full-width Tacotron-2 (EXPORT_ITERS steps, EXPORT_GL_ITERS Griffin-Lim
    iterations, text_len 64) exported on the card, loaded and served, its
    mel held to the live ``Synthesizer``'s (within MEL_TOL); the same
    program at text_len EXPORT_CPU_TEXT exported on the CPU with
    ``platforms=("cpu", "cuda")`` and loaded on the card, its mel held to
    the live ``Synthesizer``'s on the card (within MEL_TOL); the full-width vocoder exported for
    EXPORT_FRAMES frames at temperature 0 and 1, each fed the first
    EXPORT_FRAMES frames of the artifact's mel, its waveform (so its
    codes) equal to the live ``WaveNetVocoder``'s at the same seed. Prints
    the export and load times, the artifacts' sizes, the request latency
    beside the live path's and the vocoder's samples/s beside the live
    one's. Returns (ok, one-shot launches of the vocoder artifacts)."""
    import os

    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.serving import (ExportedSynthesizer, ExportedVocoder,
                                           Synthesizer, WaveNetVocoder)
    from nspeech_tpu_torch.serving.export import (MODULE_FILE, VOC_MODULE_FILE,
                                                  export_synthesizer,
                                                  export_vocoder)

    card = card_line()
    text = "An exported program speaks on the card."
    # the trace unrolls each decoder step's expand frames and each
    # Griffin-Lim iteration: the exported programs, and the live
    # synthesizers they are held to, run EXPORT_ITERS and EXPORT_GL_ITERS
    cfg = load_config("taco2").parse(
        f"max_iters={EXPORT_ITERS},griffin_lim_iters={EXPORT_GL_ITERS}")
    model = Tacotron2(cfg)
    params, bn = model.init(11)
    syn = Synthesizer(cfg, text_bucket=64).set_variables(params, bn, model=model)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def mb(path):
        return os.path.getsize(path) / 1e6

    ok = True
    _, mel_live, _ = syn.synthesize(text)          # warm-up: cuDNN, cuFFT plans
    art = os.path.join(tmp, "artifact")
    _, export_s = timed(lambda: export_synthesizer(syn, art, text_len=64))
    ex, load_s = timed(lambda: ExportedSynthesizer(art))
    (wav, mel, _), first_s = timed(lambda: ex.synthesize(text))
    gap = float(np.abs(mel - mel_live).max())
    live_s = [timed(lambda: syn.synthesize(text))[1] for _ in range(3)]
    art_s = [timed(lambda: ex.synthesize(text))[1] for _ in range(3)]
    good = (gap <= MEL_TOL and wav.size > 0 and bool(np.isfinite(wav).all()))
    ok &= good
    print(f"export taco2 (while_loop decode, max_iters={EXPORT_ITERS}, text_len 64, "
          f"{EXPORT_GL_ITERS} Griffin-Lim iterations) on the card: export {export_s:.3f} s, {mb(os.path.join(art, MODULE_FILE)):.1f} MB, "
          f"load {load_s:.3f} s, first request {first_s:.3f} s; request "
          f"{np.median(art_s):.4f} s (live {np.median(live_s):.4f} s, median of 3); "
          f"mel vs live max |diff| {gap:.3g} (tol {MEL_TOL}), wav {wav.size} "
          f"samples -> {'ok' if good else 'FAIL'} [{card}]")
    # the same weights traced on the CPU, at EXPORT_CPU_TEXT symbols (the
    # trace's time grows with the steps the encoder's BiLSTM unrolls)
    short = "Traced here."
    cpu_syn = Synthesizer(cfg, text_bucket=EXPORT_CPU_TEXT,
                          device="cpu").set_variables(params, bn, model=model)
    cpu_art = os.path.join(tmp, "artifact_cpu")
    _, cpu_export_s = timed(lambda: export_synthesizer(
        cpu_syn, cpu_art, text_len=EXPORT_CPU_TEXT, platforms=("cpu", "cuda")))
    moved, cpu_load_s = timed(lambda: ExportedSynthesizer(cpu_art, device="cuda"))
    _, mel_moved, _ = moved.synthesize(short)
    card_syn = Synthesizer(cfg, text_bucket=EXPORT_CPU_TEXT).set_variables(
        params, bn, model=model)
    gap = float(np.abs(mel_moved - card_syn.synthesize(short)[1]).max())
    good = gap <= MEL_TOL
    ok &= good
    print(f"export taco2 (max_iters={EXPORT_ITERS}, text_len "
          f"{EXPORT_CPU_TEXT}, {EXPORT_GL_ITERS} Griffin-Lim iterations) on the CPU with "
          f"platforms cpu,cuda: export {cpu_export_s:.3f} s, {mb(os.path.join(cpu_art, MODULE_FILE)):.1f} MB; "
          f"loaded on the card in {cpu_load_s:.3f} s, mel vs the live "
          f"Synthesizer on the card max |diff| {gap:.3g} (tol {MEL_TOL}) -> "
          f"{'ok' if good else 'FAIL'}")
    vcfg, net, vparams = vocoder(0)
    voc = WaveNetVocoder(vcfg).set_variables(net, vparams)
    feed = mel[:EXPORT_FRAMES]
    n = EXPORT_FRAMES * voc._hop
    voc.vocode(feed, temperature=0.0)          # warm-up: the sampler's build
    live = {t: timed(lambda: voc.vocode(feed, temperature=t, seed=7))
            for t in (0.0, 1.0)}
    vocs = {}
    for t in (0.0, 1.0):
        out = os.path.join(tmp, f"vocoder_t{t:g}")
        _, vexport_s = timed(lambda: export_vocoder(voc, out, EXPORT_FRAMES,
                                                    temperature=t))
        vocs[t], vload_s = timed(lambda: ExportedVocoder(out))
        print(f"export vocoder (T={t:g}, {EXPORT_FRAMES} frames = {n} samples): "
              f"export {vexport_s:.3f} s, {mb(os.path.join(out, VOC_MODULE_FILE)):.1f} MB, "
              f"load {vload_s:.3f} s")
    reset_launches()
    got = {t: timed(lambda: vocs[t].vocode(feed, seed=7)) for t in (0.0, 1.0)}
    launches = wavenet_gen.SAMPLER.launches
    for t in (0.0, 1.0):
        (ref, ref_s), (wav, wav_s) = live[t], got[t]
        equal = wav.shape == ref.shape and bool(np.array_equal(wav, ref))
        ok &= equal
        print(f"vocoder artifact T={t:g}: {n / wav_s:.1f} samples/s (live "
              f"{n / ref_s:.1f}), waveform equal to the live vocoder's (same "
              f"codes) {equal} -> {'ok' if equal else 'FAIL'} [{card}]")
    if launches != 2:
        print(f"FAIL: the vocoder artifacts launched the sampler {launches} "
              f"times for 2 calls")
        ok = False
    print(f"export phase sampler launches: one-shot {launches} (the vocoder "
          f"artifacts)")
    return ok, launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def turns(fns: dict, steps: int) -> dict:
    """Warm seconds per call of each of ``fns`` (name -> fn), timed in turns
    A, B, B, A (``steps`` calls per turn after one untimed call each)."""
    for fn in fns.values():
        fn()
    out = {name: [] for name in fns}
    names = list(fns)
    for name in names + names[::-1]:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            out[name].append(time.perf_counter() - t0)
    return out


def parallel_phase(tmp: str):
    """Data parallelism on one card (world size 1), after ``train_phase``
    and ``cli_phase``: (a) an NCCL process group of world size 1 in this
    process, one full-width Tacotron-2 data-parallel step (batch 32 of
    ``random_batch``, dropout from a generator) and one WaveNet step at
    WN_HPARAMS held to the plain steps on the same batches (float64
    gradients within STEP_GRAD_TOL / WN_GRAD_TOL of each leaf's largest
    entry, float32 losses within STEP_LOSS_TOL / WN_LOSS_TOL), and both
    steps timed against the plain ones in turns (the cost of the
    all-reduces when nothing is shared); (b) ``torchrun --nproc_per_node
    1 -m nspeech_tpu_torch.cli.train`` for 2 steps on ``train_phase``'s
    corpus, its first loss within STEP_LOSS_TOL of the float32 CLI's;
    (c) ``cli.synthesize --data-parallel`` with the vocoder checkpoint,
    its WAV equal sample for sample to the one without the flag (K1
    launches counted); (d) the time-sharded WaveNet logits at world size 1
    equal to the unsharded logits on the zero-padded window. Returns (ok,
    one-shot launches of (c))."""
    import contextlib
    import io
    import os
    import re
    import statistics

    from scipy.io import wavfile

    from nspeech_tpu_torch.cli import synthesize
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.models.wavenet import WaveNet
    from nspeech_tpu_torch.ops.cuda import wavenet_gen
    from nspeech_tpu_torch.ops.upsample import batch_lc
    from nspeech_tpu_torch.parallel.mesh import init_distributed
    from nspeech_tpu_torch.parallel.timeshard import make_time_sharded_logits
    from nspeech_tpu_torch.train.loop import (WaveNetDeviceBatch, batch_to_device,
                                              build_tacotron_train_step,
                                              build_wavenet_train_step,
                                              create_state, step_generator,
                                              tacotron_grads,
                                              wavenet_batch_to_device,
                                              wavenet_grads)
    from nspeech_tpu_torch.train.optim import make_optimizer
    from nspeech_tpu_torch.utils.tree import named_leaves, tree_map

    card = card_line()
    ok = True
    dp = init_distributed("cuda", rank=0, world_size=1,
                          init_method=f"tcp://127.0.0.1:{free_port()}")
    backend = torch.distributed.get_backend()
    ok &= backend == "nccl"

    # (a) Tacotron-2 at the published widths, batch 32
    cfg = load_config("taco2")
    model = Tacotron2(cfg)
    opt, sched = make_optimizer(cfg, "taco2")
    state = create_state(model, opt, 0, device="cuda")
    data = batch_to_device(random_batch(13, rows=32), "cuda")
    loss32 = {}
    for name, d in (("plain", None), ("dp", dp)):
        step = build_tacotron_train_step(model, opt, sched, dp=d)
        loss32[name] = float(step(state, data, step_generator("cuda", 0, 0))[1]["loss"])
    loss_gap = rel_err(loss32["plain"], loss32["dp"])
    torch.set_default_dtype(torch.float64)        # the decoder's zero carries too
    try:
        s64, d64 = to_float64(state, data)
        g64 = {name: dict(named_leaves(tacotron_grads(
            model, s64, d64, step_generator("cuda", 0, 0), dp=d)[0]))
            for name, d in (("plain", None), ("dp", dp))}
    finally:
        torch.set_default_dtype(torch.float32)
    del s64, d64
    gap = grad_gap(g64["plain"], g64["dp"])
    del g64
    good = loss_gap <= STEP_LOSS_TOL and gap <= STEP_GRAD_TOL
    ok &= good
    steps = {name: build_tacotron_train_step(model, opt, sched, dp=d)
             for name, d in (("plain", None), ("dp", dp))}
    secs = turns({name: (lambda f=f: float(f(state, data, step_generator(
        "cuda", 0, 0))[1]["loss"])) for name, f in steps.items()}, 2)
    del steps
    print(f"parallel taco2 data-parallel step ({backend}, world size 1, batch 32, "
          f"T_out 105, dropout 0.5 from one generator): loss {loss32['dp']:.7f} vs "
          f"plain {loss32['plain']:.7f} (rel {loss_gap:.2e}, tol {STEP_LOSS_TOL}); "
          f"float64 gradients worst leaf {gap:.2e} of its largest entry (tol "
          f"{STEP_GRAD_TOL}); warm sec/step in turns plain, dp, dp, plain: "
          f"plain median {statistics.median(secs['plain']):.4f} "
          f"({', '.join(f'{x:.4f}' for x in secs['plain'])}), dp median "
          f"{statistics.median(secs['dp']):.4f} "
          f"({', '.join(f'{x:.4f}' for x in secs['dp'])}) -> "
          f"{'ok' if good else 'FAIL'} [{card}]")
    del state, data

    # (a) WaveNet at the recipe's widths
    wcfg = wavenet_cfg(",gc_category_cardinality=1")
    net = WaveNet(wcfg)
    wopt, wsched = make_optimizer(wcfg, "wavenet")
    wstate = create_state(net, wopt, 0, device="cuda")
    rng = np.random.default_rng(17)
    window = net.receptive_field + wcfg.sample_size
    frames = (window + 250 - 2) // 250 + 2
    from nspeech_tpu_torch.data.wavenet_feeder import WaveNetBatch

    wdata = wavenet_batch_to_device(WaveNetBatch(
        rng.uniform(-0.9, 0.9, (4, window)).astype(np.float32),
        np.zeros(4, np.int32), rng.random((4, frames, 80), dtype=np.float32),
        rng.integers(0, 250, 4).astype(np.int32)), "cuda")
    wsteps = {name: build_wavenet_train_step(net, wopt, wcfg, wsched, True, True,
                                             dp=d)
              for name, d in (("plain", None), ("dp", dp))}
    wloss = {name: float(f(wstate, wdata)[1]["loss"]) for name, f in wsteps.items()}
    w64 = WaveNetDeviceBatch(wdata.audio.double(), wdata.speaker_ids,
                             batch_lc(wdata, wcfg).double(), None)
    p64 = tree_map(torch.Tensor.double, wstate.params)
    wg = {name: dict(named_leaves(wavenet_grads(net, p64, w64, wcfg, True, True,
                                                dp=d)[0]))
          for name, d in (("plain", None), ("dp", dp))}
    wgap = grad_gap(wg["plain"], wg["dp"])
    wloss_gap = rel_err(wloss["plain"], wloss["dp"])
    del wg, w64, p64
    good = wloss_gap <= WN_LOSS_TOL and wgap <= WN_GRAD_TOL
    ok &= good
    wsecs = turns({name: (lambda f=f: float(f(wstate, wdata)[1]["loss"]))
                   for name, f in wsteps.items()}, 3)
    print(f"parallel wavenet data-parallel step (world size 1, batch 4 x "
          f"{window} samples): loss {wloss['dp']:.7f} vs plain {wloss['plain']:.7f} "
          f"(rel {wloss_gap:.2e}, tol {WN_LOSS_TOL}); float64 gradients worst leaf "
          f"{wgap:.2e} (tol {WN_GRAD_TOL}); warm sec/step in turns: plain median "
          f"{statistics.median(wsecs['plain']):.4f} "
          f"({', '.join(f'{x:.4f}' for x in wsecs['plain'])}), dp median "
          f"{statistics.median(wsecs['dp']):.4f} "
          f"({', '.join(f'{x:.4f}' for x in wsecs['dp'])}) -> "
          f"{'ok' if good else 'FAIL'} [{card}]")
    del wsteps, wstate, wdata

    # (d) the time-sharded logits at world size 1, full-width vocoder
    vcfg, vnet, vparams = vocoder(5)
    T = 20480
    audio = torch.tensor(rng.uniform(-0.9, 0.9, (2, T)), dtype=torch.float32,
                         device="cuda")
    gc = torch.tensor([1, 3], device="cuda")
    lc = seeded_lc(23, 2, T, 250)
    rf = vnet.receptive_field
    with torch.no_grad():
        got, targets = make_time_sharded_logits(vnet, dp, True, True)(
            vparams, audio, gc, lc)
        ref, ref_t = vnet.forward_train(
            vparams, torch.nn.functional.pad(audio, (rf, 0)), gc_ids=gc,
            lc=torch.nn.functional.pad(lc, (0, 0, rf, 0)))
    tgap = float((got - ref).abs().max())
    good = tgap <= 1e-5 and torch.equal(targets, ref_t)
    ok &= good
    print(f"parallel time-sharded wavenet logits (world size 1, 2 x {T} samples, "
          f"full width): max |diff| {tgap:.3g} against the unsharded logits on "
          f"the zero-padded window (tol 1e-5), targets equal -> "
          f"{'ok' if good else 'FAIL'} [{card}]")
    torch.distributed.destroy_process_group()

    # (b) the trainer under torchrun, on train_phase's corpus and cache
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
         "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
         "-m", "nspeech_tpu_torch.cli.train", "--ljspeech",
         os.path.join(tmp, "corpus"), "--cache-dir", os.path.join(tmp, "features"),
         "--log-dir", os.path.join(tmp, "logs_dp"), "--model", "taco2",
         "--max-steps", "2", "--checkpoint-interval", "1000", "--seed", "0"],
        capture_output=True, text=True, env=env, cwd=root, timeout=300)
    wall = time.perf_counter() - t0
    losses = [float(x) for x in re.findall(r"loss=([-0-9.naninf]+),", proc.stdout)]
    first = FIRST_LOSS.get("taco2", float("nan"))
    good = (proc.returncode == 0 and len(losses) == 2
            and "Data-parallel over 1 ranks (nccl backend)" in proc.stdout
            and rel_err(first, losses[0]) <= STEP_LOSS_TOL and os.path.exists(
                os.path.join(tmp, "logs_dp", "taco2", "ckpt", "train", "2.pt")))
    ok &= good
    if proc.returncode != 0:
        print(proc.stdout[-3000:] + proc.stderr[-3000:])
    print(f"parallel torchrun --nproc_per_node 1 cli.train taco2 (batch 32, 2 "
          f"steps): losses {losses}, first against the float32 CLI's {first:.5f} "
          f"(rel {rel_err(first, losses[0]) if losses else float('nan'):.2e}, tol "
          f"{STEP_LOSS_TOL}), {wall:.1f} s wall -> {'ok' if good else 'FAIL'} [{card}]")

    # (c) synthesize --data-parallel against the same CLI without the flag
    argv = ["--checkpoint", os.path.join(tmp, "logs", "taco2", "ckpt"),
            "--hparams", f"max_iters={MAX_ITERS}", "--vocoder-checkpoint",
            os.path.join(tmp, "vocoder"), "--text", "Data parallel, one card.",
            "--speaker", "1"]
    wavs, walls = {}, {}
    one = 0
    for flag in (None, "--data-parallel"):
        out = os.path.join(tmp, f"dp_{bool(flag)}.wav")
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            synthesize.main(argv + ["--out", out] + ([flag] if flag else []))
        torch.cuda.synchronize()
        walls[flag] = time.perf_counter() - t0
        if flag:
            one = wavenet_gen.SAMPLER.launches
        wavs[flag] = wavfile.read(out)[1]
    equal = bool(np.array_equal(wavs["--data-parallel"], wavs[None]))
    good = equal and one >= 1 and wavs[None].size > 0
    ok &= good
    print(f"parallel cli synthesize --data-parallel (a mesh of "
          f"{torch.cuda.device_count()} card, the trained taco2 and the vocoder): "
          f"{walls['--data-parallel']:.3f} s wall (without the flag "
          f"{walls[None]:.3f} s), launches one-shot {one}, wav "
          f"{wavs[None].size} samples equal to the one without the flag "
          f"{equal} -> {'ok' if good else 'FAIL'} [{card}]")
    return ok, one


def tensor_setup(seed_batch: int = 13):
    """(model, optimizer, schedule, state, batch) of the full-width
    Tacotron-2 steps of ``tensor_phase`` on ``cuda``: the same in this
    process and in each ``--tensor-worker``."""
    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.train.loop import batch_to_device, create_state
    from nspeech_tpu_torch.train.optim import make_optimizer

    cfg = load_config("taco2")
    model = Tacotron2(cfg)
    opt, sched = make_optimizer(cfg, "taco2")
    state = create_state(model, opt, 0, device="cuda")
    return model, opt, sched, state, batch_to_device(
        random_batch(seed_batch, rows=32), "cuda")


def tensor_grads64(model, state, data, dp=None, tp=None) -> dict:
    """The float64 gradient (by path, whole) of one step with dropout
    from the step generator; with ``tp`` of the state sharded over it,
    gathered."""
    from nspeech_tpu_torch.parallel.tensor import gather_params, shard_params
    from nspeech_tpu_torch.train.loop import step_generator, tacotron_grads
    from nspeech_tpu_torch.utils.tree import named_leaves

    torch.set_default_dtype(torch.float64)        # the decoder's zero carries too
    try:
        s64, d64 = to_float64(state, data)
        if tp is not None:
            s64 = s64._replace(params=shard_params(s64.params, tp))
        grads = tacotron_grads(model, s64, d64, step_generator("cuda", 0, 0),
                               dp=dp, tp=tp)[0]
        if tp is not None:
            grads = gather_params(grads, tp)
    finally:
        torch.set_default_dtype(torch.float32)
    return dict(named_leaves(grads))


def tensor_worker(rank: int, port: int, out_dir: str) -> int:
    """Rank ``rank`` of the two gloo ranks on ``cuda:0`` of
    ``tensor_phase`` (b), model 2: one float32 step's loss, warm seconds
    per step, and (rank 0) the gathered float64 gradient, saved to
    ``out_dir``."""
    import os

    from nspeech_tpu_torch.ops.policy import set_matmul_precision
    from nspeech_tpu_torch.parallel.mesh import init_distributed
    from nspeech_tpu_torch.parallel.tensor import shard_train_state
    from nspeech_tpu_torch.train.loop import (build_tacotron_train_step,
                                              step_generator)

    set_matmul_precision("highest")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
    dp, tp = init_distributed("cuda:0", rank, 2, model_parallel=2)
    model, opt, sched, state, data = tensor_setup()
    step = build_tacotron_train_step(model, opt, sched, dp=dp, tp=tp)
    local = shard_train_state(state, tp)
    out = {"backend": torch.distributed.get_backend(tp.group), "secs": []}
    for i in range(TURN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(local, data, step_generator("cuda", 0, 0))[1]["loss"])
        torch.cuda.synchronize()
        if i:
            out["secs"].append(time.perf_counter() - t0)
        else:
            out["loss32"] = loss
    grads = tensor_grads64(model, state, data, dp, tp)
    if rank == 0:
        out["grads64"] = {k: v.cpu() for k, v in grads.items()}
    torch.save(out, os.path.join(out_dir, f"tp-{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def tensor_phase(tmp: str) -> bool:
    """Tensor parallelism of the full-width Tacotron-2 step on the one
    card, against the plain step on the same batch (phase 17): (a) data 1
    x model 1 over NCCL in this process, (b) model 2 over gloo in two
    worker processes on ``cuda:0``. Returns ok."""
    import os
    import statistics

    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.parallel.mesh import init_distributed
    from nspeech_tpu_torch.parallel.tensor import shard_train_state
    from nspeech_tpu_torch.train.loop import (build_tacotron_train_step,
                                              step_generator)

    card = card_line()
    ok = True
    model, opt, sched, state, data = tensor_setup()
    plain = build_tacotron_train_step(model, opt, sched)
    loss_plain = float(plain(state, data, step_generator("cuda", 0, 0))[1]["loss"])
    g_plain = tensor_grads64(model, state, data)

    # (a) data 1 x model 1 over NCCL
    dp, tp = init_distributed("cuda", rank=0, world_size=1,
                              init_method=f"tcp://127.0.0.1:{free_port()}",
                              model_parallel=1)
    backend = torch.distributed.get_backend(tp.group)
    local = shard_train_state(state, tp)
    sharded = build_tacotron_train_step(model, opt, sched, dp=dp, tp=tp)
    loss_tp = float(sharded(local, data, step_generator("cuda", 0, 0))[1]["loss"])
    gap = grad_gap(g_plain, tensor_grads64(model, state, data, dp, tp))
    model16 = Tacotron2(load_config("taco2").parse(BF16))
    loss16 = {name: float(build_tacotron_train_step(
        model16, opt, sched, dp=d, tp=t)(st, data, step_generator("cuda", 0, 0))[1]["loss"])
        for name, d, t, st in (("plain", None, None, state), ("tp", dp, tp, local))}
    gap16 = rel_err(loss16["plain"], loss16["tp"])
    secs = turns({"plain": lambda: float(plain(state, data, step_generator(
        "cuda", 0, 0))[1]["loss"]), "tp": lambda: float(sharded(
            local, data, step_generator("cuda", 0, 0))[1]["loss"])}, TURN_STEPS)
    torch.distributed.destroy_process_group()
    good = (backend == "nccl" and rel_err(loss_plain, loss_tp) <= STEP_LOSS_TOL
            and gap <= STEP_GRAD_TOL and np.isfinite(loss16["tp"])
            and gap16 <= TP_BF16_TOL)
    ok &= good
    print(f"tensor taco2 step, data 1 x model 1 ({backend}, batch 32, T_out 105, "
          f"dropout 0.5 from one generator): loss {loss_tp:.7f} vs plain "
          f"{loss_plain:.7f} (rel {rel_err(loss_plain, loss_tp):.2e}, tol "
          f"{STEP_LOSS_TOL}); gathered float64 gradient worst leaf {gap:.2e} (tol "
          f"{STEP_GRAD_TOL}); bf16 loss {loss16['tp']:.5f} vs plain bf16 "
          f"{loss16['plain']:.5f} (rel {gap16:.2e}, tol {TP_BF16_TOL}); warm sec/step "
          f"in turns plain, tp, tp, plain: plain median "
          f"{statistics.median(secs['plain']):.4f} "
          f"({', '.join(f'{x:.4f}' for x in secs['plain'])}), tp median "
          f"{statistics.median(secs['tp']):.4f} "
          f"({', '.join(f'{x:.4f}' for x in secs['tp'])}) -> "
          f"{'ok' if good else 'FAIL'} [{card}]")
    del local, sharded, model16

    # (b) model 2: two gloo ranks on cuda:0
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(tmp, "tensor")
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--tensor-worker", str(r), str(port), out_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=root) for r in range(2)]
    try:
        logs = [p.communicate(timeout=TP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        for r, log in enumerate(logs):
            print(f"tensor worker {r} (exit {procs[r].returncode}):\n{log[-3000:]}")
        print(f"tensor taco2 step, data 1 x model 2 (gloo on cuda:0) -> FAIL [{card}]")
        return False
    outs = [torch.load(os.path.join(out_dir, f"tp-{r}.pt"), weights_only=False)
            for r in range(2)]
    gap = grad_gap(g_plain, outs[0]["grads64"])
    losses = [o["loss32"] for o in outs]
    worst = max(rel_err(loss_plain, x) for x in losses)
    good = (all(o["backend"] == "gloo" for o in outs) and losses[0] == losses[1]
            and worst <= STEP_LOSS_TOL and gap <= STEP_GRAD_TOL)
    ok &= good
    print(f"tensor taco2 step, data 1 x model 2 (gloo on cuda:0, two processes, "
          f"batch 32, T_out 105, dropout 0.5): losses {losses[0]:.7f}, "
          f"{losses[1]:.7f} vs plain {loss_plain:.7f} (rel {worst:.2e}, tol "
          f"{STEP_LOSS_TOL}); gathered float64 gradient worst leaf {gap:.2e} (tol "
          f"{STEP_GRAD_TOL}); warm sec/step rank 0 "
          f"{', '.join(f'{x:.4f}' for x in outs[0]['secs'])}, rank 1 "
          f"{', '.join(f'{x:.4f}' for x in outs[1]['secs'])}; {wall:.1f} s wall "
          f"with start-up -> {'ok' if good else 'FAIL'} [{card}]")
    return ok


def loader_phase(tmp: str) -> bool:
    """The C++ audio loader built with this machine's g++: a seeded 5 s
    WAV at 22,050 Hz (resampled to 20,000 Hz) and a 5 s FLAC at 20,000 Hz
    against the Python copies (``dsp/wavio.py``: scipy's resample_poly;
    ``dsp/flacio.py``), within 1e-3 where the file is resampled and 1e-6
    where it is not (the bounds of the JAX package's loader tests); ms per
    utterance for each."""
    import os

    from scipy.io import wavfile

    from nspeech_tpu_torch import native
    from nspeech_tpu_torch.dsp.wavio import load_wav as py_load_wav

    make_flac = repo_module("tests/make_flac.py")

    card = card_line()
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    ok = True
    lines = []
    for name, sr, target, tol in (("wav 22050 Hz", 22050, 20000, 1e-3),
                                  ("flac 20000 Hz", 20000, 20000, 1e-6)):
        t = np.arange(5 * sr) / sr
        x = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 2333 * t)
             + 0.05 * rng.standard_normal(t.size))
        ints = np.round(np.clip(x, -0.99, 0.99) * 32767).astype(np.int64)
        if name.startswith("wav"):
            path = os.path.join(tmp, "loader.wav")
            wavfile.write(path, sr, ints.astype(np.int16))
        else:
            path = make_flac.write_flac(os.path.join(tmp, "loader.flac"), ints, sr)
        ms = {}
        for label, fn in (("native", native.load_wav), ("python", py_load_wav)):
            t0 = time.perf_counter()
            for _ in range(LOADER_REPS):
                out = fn(path, target)
            ms[label] = (time.perf_counter() - t0) / LOADER_REPS * 1e3
            ms[label + "_out"] = out
        gap = float(np.abs(ms["native_out"] - ms["python_out"]).max())
        good = ms["native_out"].shape == ms["python_out"].shape and gap <= tol
        ok &= good
        lines.append(f"{name}: {ms['native']:.2f} ms native, {ms['python']:.2f} ms "
                     f"python per 5 s utterance, max gap {gap:.2e} (bound {tol})")
    print(f"loader: built with g++ in {build_s:.1f} s; " + "; ".join(lines)
          + f" -> {'ok' if ok else 'FAIL'} [{card}]")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke runs on the card", file=sys.stderr)
        return 1
    from nspeech_tpu_torch.ops.policy import set_matmul_precision

    set_matmul_precision("highest")
    print(card_line())
    start = time.perf_counter()

    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    record = phase(kernel_phase)
    carried = phase(carried_phase)
    primed = phase(primed_phase)
    e2e_ok, record["launches"] = phase(e2e_phase)
    stream_ok, carried["launches"] = phase(streaming_phase)
    taco1_ok, one, more = phase(taco1_phase)
    record["launches"] += one
    carried["launches"] += more
    server_ok, one, more = phase(server_phase)
    record["launches"] += one
    carried["launches"] += more
    with tempfile.TemporaryDirectory() as tmp:
        loader_ok = phase(loader_phase, tmp)
        cli_ok, (one, primed["launches"], more) = phase(cli_phase, tmp)
        record["launches"] += one
        carried["launches"] += more
        train_ok, one = phase(train_phase, tmp)
        record["launches"] += one
        wn_ok, one = phase(wavenet_train_phase, tmp)
        record["launches"] += one
        bf16_ok, one, more = phase(bf16_phase, tmp)
        record["launches"] += one
        carried["launches"] += more
        import_ok, one = phase(import_phase, tmp)
        record["launches"] += one
        export_ok, one = phase(export_phase, tmp)
        record["launches"] += one
        parallel_ok, one = phase(parallel_phase, tmp)
        record["launches"] += one
        tensor_ok = phase(tensor_phase, tmp)
    print(f"smoke took {time.perf_counter() - start:.1f} s after the card line")
    for rec in (record, carried, primed):
        for form, ms, bound in rec.pop("per_sample"):
            print(f"{form}: {ms * 1e3:.2f} us per sample, bound {bound * 1e3:.4f} "
                  f"us ({ms / bound:.0f} x the bound)")
    print(json.dumps({"kernels": [record, carried, primed]}))
    if not (record["checked"] and carried["checked"] and primed["checked"]
            and e2e_ok and stream_ok and taco1_ok and server_ok and cli_ok
            and train_ok and wn_ok and bf16_ok and loader_ok and import_ok
            and export_ok and parallel_ok and tensor_ok):
        print("FAIL", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tensor-worker"]:
        sys.exit(tensor_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
