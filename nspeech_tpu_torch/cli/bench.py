"""The port's benchmark harness: one JSON line per metric, headline first.

    python -m nspeech_tpu_torch.cli.bench [--steps 10] [--batch-size 32] \
        [--precision bfloat16] [--hparams k=v,...] [--device cuda]

Port of the JAX package's ``bench.py``: its fifteen metrics in its phase
order, its record (``metric``, ``value``, ``unit``, ``vs_baseline``,
``precision``), its per-phase budget gate (``NSPEECH_BENCH_BUDGET_S``, 1140
s by default) and the headline record printed again as the last line.

Headline: Tacotron-2 training throughput in mel frames per second per
card. Also: MFU and sec/step, the same under the bf16 compute policy,
WaveNet training throughput (plain, mel-conditioned, and mel-conditioned
under bf16) and, on the card only, the mel-conditioned vocoder's rate, the
CUDA sampler's rate at one stream and at 8, Tacotron-2 serving latency at
the full decode budget, and streaming time to first audio with the batch-8
real-time factor. Training rates are chained steps with one sync at the end
and the slope over two run lengths; the sampler and vocoder rates the slope
of the best of several calls over two lengths.

Where it differs from ``bench.py``:

* ``--device`` (``cuda`` by default) in place of the JAX platform. Without
  a card ``--device cuda`` prints one error line shaped like the headline
  record and exits 1; ``--device cpu`` runs the training phases alone.
* MFU divides an analytic count of the step's products
  (:func:`taco2_train_step_flops`, the same whatever the implementation)
  by the card's dense peak for the precision (:data:`PEAK_FLOPS`), where
  ``bench.py`` reads XLA's cost analysis; no MFU on the CPU.
* The sampler's two metrics are named for the CUDA kernel.
* ``vs_baseline`` is null wherever ``bench.py`` divides by a TPU target;
  the two ratios of the port's own numbers stay (decoded audio seconds
  over serving latency, cap latency over time to first audio).
* No phase is wrapped in an ``except``: a failed phase raises and the run
  exits non-zero after the lines already printed.
* No relay probe and no compile cache: the sampler's ``nvcc`` build is
  cached in ``build/`` and happens in a warm-up call, outside every timed
  window.

At its end the run prints the sampler's launches per form on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict

import numpy as np
import torch

from nspeech_tpu_torch.config import load_config, stft_params
from nspeech_tpu_torch.data.feeder import Batch
from nspeech_tpu_torch.data.wavenet_feeder import WaveNetBatch
from nspeech_tpu_torch.models import WaveNet, create_model
from nspeech_tpu_torch.models.attention import _LOCATION_FILTERS, _LOCATION_KERNEL
from nspeech_tpu_torch.ops import policy
from nspeech_tpu_torch.ops.cuda import wavenet_gen
from nspeech_tpu_torch.ops.layers import tree_to
from nspeech_tpu_torch.train.loop import (batch_to_device,
                                          build_tacotron_train_step,
                                          build_wavenet_train_step,
                                          create_state, step_generator,
                                          wavenet_batch_to_device)
from nspeech_tpu_torch.train.optim import make_optimizer
from nspeech_tpu_torch.train.runner import pick_mesh

HEADLINE_METRIC = "taco2_train_mel_frames_per_sec_per_chip"

# Dense peak FLOP/s per card by torch.cuda.get_device_name(0), keyed by the
# arithmetic the products run in: float32 under --precision highest, TF32
# under tensorfloat32 or bfloat16 (PyTorch's "medium" runs TF32 on the
# H100), bf16 under compute_dtype=bfloat16. NVIDIA's figures for the H100
# SXM part, without sparsity.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"highest": 67e12, "tensorfloat32": 495e12,
                              "bfloat16": 495e12, "bfloat16_policy": 989e12},
}


def _chip_peak_flops(precision: str, compute_dtype: str = "float32",
                     name: str = None) -> float:
    """The card's dense peak for products under ``precision`` (the
    ``--precision`` flag) and ``compute_dtype`` (the hparam); ``name`` is
    ``torch.cuda.get_device_name(0)`` by default. A card the table lacks
    raises."""
    name = torch.cuda.get_device_name(0) if name is None else name
    if name not in PEAK_FLOPS:
        raise KeyError(f"no peak FLOP/s for card {name!r}: add it to "
                       "nspeech_tpu_torch/cli/bench.py PEAK_FLOPS")
    key = "bfloat16_policy" if compute_dtype == "bfloat16" else precision
    return PEAK_FLOPS[name][key]


def _product(m: int, k: int, n: int, dx: bool = True) -> int:
    """FLOPs of an [m, k] x [k, n] product in a train step: 2mkn forward,
    2mkn for the weight's gradient and, where the input carries a
    gradient (``dx``), 2mkn for the input's."""
    return 2 * m * k * n * (3 if dx else 2)


def _conv_stack(rows: int, in_ch: int, layers: int, width: int,
                channels: int) -> int:
    """A stack of 'SAME' convolutions over ``rows`` = batch x time
    positions, each a [rows, width * in] x [width * in, channels] product
    whose input carries a gradient."""
    total = 0
    for _ in range(layers):
        total += _product(rows, width * in_ch, channels)
        in_ch = channels
    return total


def _bilstm(batch: int, steps: int, in_ch: int, units: int) -> int:
    """Both directions of a BiLSTM: the input product of every step, and
    the recurrent one at each step, whose first step reads the zero state
    (no input gradient there)."""
    rec = 2 * (2 * batch) * units * (4 * units)
    return _product(2 * batch * steps, in_ch, 4 * units) + rec * (3 * steps - 1)


def taco2_flop_terms(cfg, batch_size: int, t_in: int, t_out: int) -> Dict[str, int]:
    """FLOPs of the products and convolutions of one Tacotron-2 train step
    (forward, and the backward autograd takes), by part of the model.

    Counted from the config's widths and the batch shape: [batch_size,
    t_in] text, t_out frames (a multiple of ``outputs_per_step``, so S =
    t_out / r decoder steps), teacher-forced. Each product counts 2mkn
    forward, 2mkn for its weight's gradient and 2mkn for its input's where
    the input carries one: not where it is data (the teacher frames), the
    zero first state of a recurrence or the zero first context and
    alignment of the decoder. Elementwise work, the loss and the optimizer
    count nothing. How the step computes these products (one per step or
    stacked, deferred or not, fused or not) does not change the count."""
    r = int(cfg.outputs_per_step)
    if t_out % r:
        raise ValueError(f"t_out={t_out} is not a multiple of r={r}")
    B, T, S = batch_size, t_in, t_out // r
    M, A, D = cfg.num_mels, cfg.attention_dim, cfg.decoder_lstm_units
    Dm = 2 * cfg.encoder_lstm_units
    attn_in = 128
    terms = {}
    if cfg.num_speakers > 1:
        terms["speaker_prenet"] = _product(B, cfg.speaker_embed_dim, 128)
        attn_in += 128
    terms["encoder_convs"] = _conv_stack(
        B * T, cfg.embedding_dim, cfg.encoder_conv_layers,
        cfg.encoder_conv_width, cfg.encoder_conv_channels)
    terms["encoder_lstm"] = _bilstm(B, T, cfg.encoder_conv_channels,
                                    cfg.encoder_lstm_units)
    terms["attention_memory"] = _product(B * T, Dm, A)
    # step 0 reads the GO frame and the zero context: no input gradient
    terms["decoder_prenet"] = (_product(B, M + Dm, 256, dx=False)
                               + (S - 1) * _product(B, M + Dm, 256)
                               + S * _product(B, 256, 128))
    terms["decoder_lstms"] = S * (_product(B, attn_in + A, 4 * A)
                                  + _product(B, A + Dm + D, 4 * D)
                                  + _product(B, 2 * D, 4 * D))
    terms["attention_query"] = S * _product(B, A, A)
    # the location conv reads the previous alignment, zero at step 0
    conv = _LOCATION_KERNEL * 1
    terms["attention_location"] = (
        _product(B * T, conv, _LOCATION_FILTERS, dx=False)
        + (S - 1) * _product(B * T, conv, _LOCATION_FILTERS)
        + S * _product(B * T, _LOCATION_FILTERS, A))
    terms["attention_score"] = S * _product(B * T, A, 1)      # energy . v
    terms["attention_context"] = S * _product(B, T, Dm)      # alignments @ memory
    terms["frame_proj"] = S * _product(B, D, M * r)
    P = cfg.postnet_conv_channels
    terms["postnet"] = (_conv_stack(B * t_out, M, cfg.postnet_conv_layers,
                                    cfg.postnet_conv_width, P)
                        + _product(B * t_out, P, M))
    terms["expand_convs"] = _conv_stack(
        B * t_out, M, cfg.expand_conv_layers, cfg.expand_conv_width,
        cfg.expand_conv_channels)
    terms["expand_lstm"] = _bilstm(B, t_out, cfg.expand_conv_channels,
                                   cfg.expand_lstm_units)
    terms["linear_proj"] = _product(B * t_out, 2 * cfg.expand_lstm_units,
                                    cfg.num_freq)
    return terms


def taco2_train_step_flops(cfg, batch_size: int, t_in: int, t_out: int) -> int:
    """The FLOPs MFU divides: the sum of :func:`taco2_flop_terms`."""
    return sum(taco2_flop_terms(cfg, batch_size, t_in, t_out).values())


def _set_precision(precision: str, device: torch.device) -> None:
    if device.type == "cuda":
        policy.set_matmul_precision(precision)


def bench_taco2_train(batch_size: int = 32, t_in: int = 160, t_out: int = 400,
                      steps: int = 10, precision: str = "bfloat16",
                      hparams: str = "", device="cuda"):
    """Returns (frames/sec/card, sec_per_step, mfu); mfu is None off the
    card."""
    device = torch.device(device)
    _set_precision(precision, device)
    cfg = load_config("taco2")
    cfg.batch_size = batch_size
    # experiment overrides; the frame budget stays a multiple of r, as the
    # feeder guarantees
    cfg.parse(hparams)
    r = int(cfg.outputs_per_step)
    t_out = ((t_out + r - 1) // r) * r
    model = create_model("taco2", cfg)
    tx, schedule = make_optimizer(cfg, "taco2")
    dp = pick_mesh(batch_size, device)
    if dp is not None:
        device = dp.device
    step_fn = build_tacotron_train_step(model, tx, schedule=schedule, dp=dp)
    state = create_state(model, tx, 0, device=device)

    rng = np.random.default_rng(0)
    batch = Batch(
        inputs=rng.integers(2, 60, (batch_size, t_in)).astype(np.int32),
        input_lengths=np.full((batch_size,), t_in, np.int32),
        speaker_ids=np.zeros((batch_size,), np.int32),
        mel_targets=rng.random((batch_size, t_out, cfg.num_mels)).astype(np.float32),
        linear_targets=rng.random((batch_size, t_out, cfg.num_freq)).astype(np.float32),
        audio=np.zeros((batch_size, 16), np.float32),
    )
    if dp is not None:
        rows = dp.rows(batch_size)
        batch = Batch(*(x[rows] for x in batch))
    batch = batch_to_device(batch, device)

    # warm-up; float() of the loss is the sync point
    for i in range(2):
        state, metrics = step_fn(state, batch, step_generator(device, 1, 100 + i))
        float(metrics["loss"])
    _phase("  taco2: warm, timing steps")

    # a chain of steps with one sync at its end, as a training loop that
    # reads its metrics every k steps
    def chain_time(n: int) -> float:
        nonlocal state
        start = time.perf_counter()
        for i in range(n):
            state, m = step_fn(state, batch, step_generator(device, 1, i))
        float(m["loss"])
        return time.perf_counter() - start
    # the slope over two run lengths drops the chain's fixed cost
    short = max(1, steps // 4)
    steps = max(steps, short + 1)
    sec_per_step = (chain_time(steps) - chain_time(short)) / (steps - short)

    world = 1 if dp is None else dp.world
    mfu = None
    if device.type == "cuda":
        mfu = (taco2_train_step_flops(cfg, batch_size, t_in, t_out) / sec_per_step
               / (_chip_peak_flops(precision, cfg.compute_dtype) * world))
    return batch_size * t_out / sec_per_step / world, sec_per_step, mfu


def bench_wavenet_train(batch_size: int = 4, sample_size: int = 20480,
                        steps: int = 8, precision: str = "bfloat16",
                        use_lc: bool = False, hparams: str = "", device="cuda"):
    """Sustained WaveNet training rate in audio samples/sec/card (chained
    steps, as the Tacotron bench). ``use_lc`` measures the mel-conditioned
    vocoder (lc_channels=80, frame-rate mels upsampled on the device, the
    layout the feeder ships)."""
    device = torch.device(device)
    _set_precision(precision, device)
    cfg = load_config("wavenet")
    if use_lc:
        cfg.parse("lc_channels=80")
    cfg.parse(hparams)
    net = WaveNet(cfg)
    tx, schedule = make_optimizer(cfg, "wavenet")
    step_fn = build_wavenet_train_step(net, tx, cfg, schedule=schedule,
                                       use_lc=use_lc)
    state = create_state(net, tx, 0, device=device)

    rng = np.random.default_rng(0)
    T = net.receptive_field + sample_size
    if use_lc:
        _, hop, _ = stft_params(cfg)
        mel = rng.random((batch_size, T // hop + 2, cfg.num_mels), np.float32)
        phase = np.zeros((batch_size,), np.int32)
    else:
        mel = np.zeros((batch_size, T, cfg.num_mels), np.float32)
        phase = None
    batch = wavenet_batch_to_device(WaveNetBatch(
        audio=rng.random((batch_size, T), np.float32) * 2 - 1,
        speaker_ids=np.zeros((batch_size,), np.int32),
        mel=mel, mel_phase=phase), device)
    for _ in range(2):
        state, m = step_fn(state, batch)
        float(m["loss"])

    def chain_time(n):
        nonlocal state
        start = time.perf_counter()
        for _ in range(n):
            state, m = step_fn(state, batch)
        float(m["loss"])
        return time.perf_counter() - start

    short = max(1, steps // 4)
    steps = max(steps, short + 1)
    sec_per_step = (chain_time(steps) - chain_time(short)) / (steps - short)
    return batch_size * sample_size / sec_per_step


def bench_wavenet_generate(batch: int = 1, device="cuda"):
    """The CUDA sampler at the default 50-layer config, K1 (one stream) or
    K2 (``batch`` streams): the slope over 4,096 and 24,576 samples of the
    best of 4 calls each. Returns (aggregate samples/sec, real-time
    factor)."""
    cfg = load_config("wavenet")
    net = WaveNet(cfg)
    gen = wavenet_gen.CudaWaveNetGenerator(net, tree_to(net.init(0), device))

    def best_time(n: int) -> float:
        gen(n, seed=0, batch=batch).cpu()  # warm (the first call builds the kernel)
        best = float("inf")
        for s in range(4):
            start = time.perf_counter()
            gen(n, seed=1 + s, batch=batch).cpu()
            best = min(best, time.perf_counter() - start)
        return best

    n_small, n_large = 4096, 24576
    sec_per_sample = (best_time(n_large) - best_time(n_small)) / (
        n_large - n_small)
    rate = batch / sec_per_sample
    return rate, rate / cfg.sample_rate


def bench_vocoder_lc(device="cuda") -> float:
    """Mel-conditioned vocode rate in samples/sec (``WaveNetVocoder``, lc
    80, one stream): the slope over 32 and 160 frames of the best of 3
    calls each."""
    from nspeech_tpu_torch.serving import WaveNetVocoder

    cfg = load_config("wavenet")
    cfg.parse("lc_channels=80")
    net = WaveNet(cfg)
    voc = WaveNetVocoder(cfg, device=device).set_variables(net, net.init(0))
    rng = np.random.default_rng(0)

    def voc_time(frames: int):
        mel = rng.random((frames, cfg.num_mels)).astype(np.float32)
        voc.vocode(mel)  # warm
        best = float("inf")
        for _ in range(3):
            start = time.perf_counter()
            wav = voc.vocode(mel)
            best = min(best, time.perf_counter() - start)
        return best, len(wav)

    t_small, n_small = voc_time(32)
    t_large, n_large = voc_time(160)   # 2 s at 12.5 ms hop
    return (n_large - n_small) / (t_large - t_small)


def _taco2_synthesizer(precision: str, device):
    """Tacotron-2 with seeded random weights behind a ``Synthesizer``,
    its products under ``precision`` as the training phases' (the
    Synthesizer itself sets ``highest``)."""
    from nspeech_tpu_torch.serving import Synthesizer

    cfg = load_config("taco2")
    model = create_model("taco2", cfg)
    params, bn_state = model.init(0)
    syn = Synthesizer(cfg, device=device).set_variables(params, bn_state,
                                                        model=model)
    _set_precision(precision, syn.device)
    return syn


def bench_taco2_serving(precision: str = "bfloat16", device="cuda"):
    """Text -> waveform latency through ``Synthesizer`` (decode and
    Griffin-Lim), in seconds per utterance. Random weights never cross the
    stop threshold, so the decoder runs its whole ``max_iters`` budget:
    the upper bound. Returns (best-of-3 seconds with the features, without
    them, decoded audio seconds)."""
    syn = _taco2_synthesizer(precision, device)
    cfg = syn.cfg
    text = "The birch canoe slid on the smooth planks across the lake."
    wav, mel, _ = syn.synthesize(text)  # warm
    best = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        syn.synthesize(text)
        best = min(best, time.perf_counter() - start)
    # wav only (the GET /synthesize semantics): no mel or linear to the host
    best_wav = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        syn.synthesize(text, want_features=False)
        best_wav = min(best_wav, time.perf_counter() - start)
    _, hop, _ = stft_params(cfg)
    audio_secs = mel.shape[0] * hop / cfg.sample_rate
    return best, best_wav, audio_secs


def bench_streaming_first_audio(precision: str = "bfloat16", device="cuda"):
    """Time to first audio of ``StreamingTTS`` (chunk_frames=40): seconds
    from the ``stream()`` call until the first waveform chunk is on the
    host, best of 3; then 8 streams through one ``stream_batch``, whose
    aggregate real-time factor is audio seconds over wall seconds. The
    vocoder launches are the sampler's carried form (K4). Each timing
    starts on an idle card. Returns (first-audio seconds, batch-8
    real-time factor)."""
    from nspeech_tpu_torch.serving import StreamingTTS, WaveNetVocoder

    syn = _taco2_synthesizer(precision, device)
    cfg = syn.cfg
    vcfg = load_config("wavenet")
    vcfg.parse("lc_channels=80")
    net = WaveNet(vcfg)
    voc = WaveNetVocoder(vcfg, device=device).set_variables(net, net.init(1))
    tts = StreamingTTS(syn, voc, chunk_frames=40)
    text = "The birch canoe slid on the smooth planks across the lake."

    def idle():
        if syn.device.type == "cuda":
            torch.cuda.synchronize(syn.device)

    def first_chunk_sec() -> float:
        idle()
        start = time.perf_counter()
        for _ in tts.stream(text):
            return time.perf_counter() - start
        raise RuntimeError("stream produced no audio")

    first_chunk_sec()  # warm
    ttfa = min(first_chunk_sec() for _ in range(3))

    texts = [text,
             "Glue the sheet to the dark blue background of the wall.",
             "It is easy to tell the depth of a deep well today.",
             "These days a chicken leg is quite a rare dish indeed.",
             "Rice is often served in round bowls at dinner time.",
             "The juice of lemons makes fine punch for everyone.",
             "The box was thrown beside the parked truck outside.",
             "The hogs were fed with chopped corn and garbage."]
    list(tts.stream_batch(texts))  # warm
    idle()
    start = time.perf_counter()
    samples = sum(len(c) for chunks in tts.stream_batch(texts)
                  for c in chunks if c is not None)
    wall = time.perf_counter() - start
    rt8 = (samples / cfg.sample_rate) / wall
    return ttfa, rt8


_BENCH_T0 = time.monotonic()
_HEADLINE = {}  # first-emitted record, re-printed as the final line


def _emit(metric: str, value, unit: str, vs_baseline, precision: str) -> None:
    rec = {
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_baseline": vs_baseline,
        "precision": precision,
    }
    if not _HEADLINE:
        _HEADLINE.update(rec)
    print(json.dumps(rec), flush=True)


def _phase(name: str) -> None:
    print("bench: [t=%.0fs] %s" % (time.monotonic() - _BENCH_T0, name),
          file=sys.stderr, flush=True)


def _fits(budget_s: float, est_s: float, name: str) -> bool:
    """Start a phase only if its worst-case cost fits the wall budget.

    A caller that wraps the run in a hard timeout loses the whole record
    to a kill mid-metric, so each phase starts only when ``elapsed +
    worst-case estimate`` stays inside the budget, and is skipped loudly
    otherwise (exit stays 0, the metrics already emitted stand). Phases
    run most important first, so a short budget sheds the least valuable
    rows."""
    elapsed = time.monotonic() - _BENCH_T0
    if elapsed + est_s <= budget_s:
        return True
    print("bench: [t=%.0fs] skipping %s (worst-case ~%.0fs would pass the "
          "%.0fs budget; set NSPEECH_BENCH_BUDGET_S to raise)"
          % (elapsed, name, est_s, budget_s), file=sys.stderr, flush=True)
    return False


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _require_card(device: torch.device) -> None:
    """On ``cuda``: without a card, one JSON line shaped like the headline
    record with ``value`` null and the ``error``, then exit 1 (there is no
    CPU fallback); with one, its name and power limit on stderr."""
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        print(json.dumps({
            "metric": HEADLINE_METRIC,
            "value": None, "unit": "frames/sec/chip", "vs_baseline": None,
            "error": "no CUDA card: torch.cuda.is_available() is false "
                     "(--device cpu runs the training phases on the host)",
        }), flush=True)
        raise SystemExit(1)
    _phase("card: " + card_line())


def _print_launches() -> None:
    """The sampler's launches per form in this run, on stderr."""
    counts = {"one_shot": wavenet_gen.SAMPLER.launches,
              "primed": wavenet_gen.PRIMED_SAMPLER.launches,
              "carried": wavenet_gen.CARRIED_SAMPLER.launches}
    print("bench: sampler launches " + json.dumps(counts), file=sys.stderr,
          flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--all", action="store_true",
                        help="Accepted for compatibility; every metric is "
                             "emitted by default (with --device cpu the "
                             "sampling / vocoder / serving metrics are "
                             "skipped: the kernel needs the card)")
    parser.add_argument("--steps", type=int, default=10,
                        help="timed steps per training bench (Tacotron-2 "
                             "and both WaveNet configurations)")
    parser.add_argument("--batch-size", type=int, default=32,
                        help="Tacotron-2 training bench batch size (the "
                             "WaveNet benches keep their own default)")
    parser.add_argument("--precision", default="bfloat16",
                        choices=list(policy.MATMUL_PRECISIONS))
    parser.add_argument("--hparams", default="",
                        help="k=v overrides for the Tacotron-2 training "
                             "bench config (e.g. outputs_per_step=3)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (one card) or cpu (the training phases)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    _require_card(device)
    budget_s = float(os.environ.get("NSPEECH_BENCH_BUDGET_S", "1140"))

    _phase("taco2 train (headline)")
    frames_per_sec, sec_per_step, mfu = bench_taco2_train(
        batch_size=args.batch_size, steps=args.steps,
        precision=args.precision, hparams=args.hparams, device=device)
    _emit(HEADLINE_METRIC, round(frames_per_sec, 1), "frames/sec/chip", None,
          args.precision)
    if mfu is not None:
        _emit("taco2_train_mfu", round(mfu, 4), "fraction_of_peak", None,
              args.precision)
    _emit("taco2_sec_per_step", round(sec_per_step, 4), "sec", None,
          args.precision)

    on_card = device.type == "cuda"
    # Each estimate: twice the longest of three runs of this CLI (--steps 3
    # once, the defaults twice) on an NVIDIA H100 80GB HBM3 at 700.00 W,
    # rounded up; the measured seconds beside it.
    if _fits(budget_s, 30, "bf16-policy taco2 train"):       # 12-13 s
        _phase("bf16-policy taco2 train")
        fps16, _, mfu16 = bench_taco2_train(
            batch_size=args.batch_size, steps=args.steps,
            precision=args.precision,
            hparams=",".join(p for p in (args.hparams, "compute_dtype=bfloat16")
                             if p),
            device=device)
        _emit("taco2_train_mel_frames_per_sec_per_chip_bf16",
              round(fps16, 1), "frames/sec/chip", None, "bfloat16_policy")
        if mfu16 is not None:
            _emit("taco2_train_mfu_bf16", round(mfu16, 4),
                  "fraction_of_peak", None, "bfloat16_policy")

    # the first phase that launches the sampler: with its nvcc build 19 s
    if on_card and _fits(budget_s, 40, "mel-conditioned vocoder rate"):  # 11 s
        _phase("mel-conditioned vocoder rate")
        rate_lc = bench_vocoder_lc(device)
        _emit("wavenet_vocoder_lc_samples_per_sec", round(rate_lc, 1),
              "samples/sec", None, "float32")

    if _fits(budget_s, 10, "wavenet train"):                  # 1-2 s
        _phase("wavenet train")
        rate_tr = bench_wavenet_train(steps=args.steps,
                                      precision=args.precision, device=device)
        _emit("wavenet_train_samples_per_sec_per_chip", round(rate_tr, 1),
              "samples/sec/chip", None, args.precision)
    if _fits(budget_s, 10, "wavenet train (mel-conditioned)"):  # 1-3 s
        _phase("wavenet train (mel-conditioned)")
        rate_tr_lc = bench_wavenet_train(steps=args.steps,
                                         precision=args.precision,
                                         use_lc=True, device=device)
        _emit("wavenet_train_lc_samples_per_sec_per_chip",
              round(rate_tr_lc, 1), "samples/sec/chip", None, args.precision)
    if _fits(budget_s, 10, "bf16-policy wavenet"):            # 1-3 s
        _phase("bf16-policy wavenet")
        rate_lc16 = bench_wavenet_train(
            steps=args.steps, precision=args.precision, use_lc=True,
            hparams="compute_dtype=bfloat16", device=device)
        _emit("wavenet_train_lc_samples_per_sec_per_chip_bf16",
              round(rate_lc16, 1), "samples/sec/chip", None,
              "bfloat16_policy")

    # the sampler is a CUDA kernel: the card-only phases need the card
    if not on_card:
        print("bench: skipping CUDA sampling / vocoder / serving metrics "
              "(card-only; device is %s)" % device, file=sys.stderr)
    sec_utt = None
    if on_card and _fits(budget_s, 40, "cuda sampling"):      # 15-16 s
        _phase("cuda sampling")
        rate, _ = bench_wavenet_generate(batch=1, device=device)
        _emit("wavenet_cuda_single_stream_samples_per_sec", round(rate, 1),
              "samples/sec", None, "float32")
        rate8, _ = bench_wavenet_generate(batch=8, device=device)
        _emit("wavenet_cuda_batch8_samples_per_sec_per_chip",
              round(rate8, 1), "samples/sec/chip", None, "float32")
    if on_card and _fits(budget_s, 20, "taco2 serving latency"):  # 6-7 s
        # vs_baseline: decoded audio seconds over the latency, how many
        # times faster than real time the serving path runs
        _phase("taco2 serving latency")
        sec_utt, sec_wav_only, audio_secs = bench_taco2_serving(
            args.precision, device)
        _emit("taco2_serving_sec_per_utterance_cap", round(sec_utt, 4),
              "sec", round(audio_secs / sec_utt, 2), args.precision)
        _emit("taco2_serving_wav_only_sec", round(sec_wav_only, 4),
              "sec", round(audio_secs / sec_wav_only, 2), args.precision)
    if on_card and _fits(budget_s, 120, "streaming first-audio"):  # ~50 s
        # vs_baseline: the one-shot cap latency over time to first audio
        _phase("streaming first-audio + batch-8")
        ttfa, rt8 = bench_streaming_first_audio(args.precision, device)
        _emit("taco2_streaming_first_audio_sec", round(ttfa, 4), "sec",
              round(sec_utt / ttfa, 2) if sec_utt else None, args.precision)
        _emit("taco2_stream_batch8_rt_aggregate", round(rt8, 2),
              "x_realtime", None, args.precision)

    _phase("done")
    _print_launches()
    # the headline again as the last line: a reader of the last line (or of
    # the tail of the output) finds it however many phases ran
    if _HEADLINE:
        print(json.dumps(_HEADLINE), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
