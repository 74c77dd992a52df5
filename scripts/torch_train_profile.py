"""Where a training step of the port goes, on one CUDA card.

    python3 scripts/torch_train_profile.py                  # Tacotron-2
    python3 scripts/torch_train_profile.py --model wavenet  # the vocoder
    python3 scripts/torch_train_profile.py --model wavenet --profile-only \
        --hparams compute_dtype=bfloat16                    # bf16 policy

Run from the repository root on a machine with the card. It writes the
synthetic corpus of ``chip_smoke.py``'s training phase into a temporary
directory and prints:

1. The card against the CPU, one Tacotron-2 training step at the
   published widths, no dropout, on 9 batches of 4 (the corpus's 4
   shortest utterances at two init seeds, the next 4, and
   ``chip_smoke.random_batch`` at seeds 0-5): the losses in float32 and
   float64; how many of the L1 losses' signs and of the relus' masks
   differ between the card, the CPU and float64; the worst leaf (largest
   error over the leaf's largest entry) of five comparisons: the card
   for the CPU's output cotangents, the card's own, the CPU and the card
   in float32 for the float64 cotangents against float64, and the card
   in float64 against the CPU in float64; the whole gradient's 2-norm
   errors; the 4 worst leaves of the first comparison; then one
   ``step_fn`` per device: the loss, ``grad_norm`` and the update's norm.
2. One training step at batch 32 on the longest batch (after two warm-up
   steps): its wall time, then the same step under ``torch.profiler``:
   the device time by operation, the host time by operation, the count
   of kernel launches and the device's busy share of the step.

With ``--model wavenet`` it does the same for the vocoder at the repo's
recipe (``chip_smoke.WN_HPARAMS``: the ``wavenet`` preset, lc 80, gc 16):
``chip_smoke.wavenet_card_vs_cpu`` on 8 windows of 5,117 + 2,048 samples
of the corpus (batch 1), with the post-net relu masks that differ between
the card and the CPU; then, at batch 4 windows of 5,117 + 20,480 samples,
the wall time of 5 warm steps (after 2 warm-up steps), the peak memory,
and one step under ``torch.profiler`` as above.

``--hparams k=v,...`` applies to the profiled step's configuration (for
example ``compute_dtype=bfloat16``); ``--profile-only`` skips part 1;
``--no-deferred`` profiles the Tacotron-2 step with every weight
gradient from autograd (``deferred_dw=False``) in place of the default
deferred step. The summary line gives ``aten::add_``'s share of the
kernel time and its costliest input shapes.
The profiled step is also written as a Chrome trace under
``--trace-dir`` (default ``build/profile``; ``utils/profiling.py``
``trace``) and its 15 costliest device operations printed from that trace
(``summarize_trace``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402  (the training phase's corpus)
from nspeech_tpu_torch.config import load_config  # noqa: E402
from nspeech_tpu_torch.data.corpus import load_items  # noqa: E402
from nspeech_tpu_torch.data.feeder import DataFeeder  # noqa: E402
from nspeech_tpu_torch.models.tacotron2 import Tacotron2  # noqa: E402
from nspeech_tpu_torch.train.loop import (batch_to_device,  # noqa: E402
                                          build_tacotron_train_step,
                                          build_wavenet_train_step,
                                          create_state, step_generator,
                                          wavenet_batch_to_device)
from nspeech_tpu_torch.train.optim import make_optimizer  # noqa: E402
from nspeech_tpu_torch.utils.tree import named_leaves, tree_leaves, tree_map  # noqa: E402


class ReluMasks:
    """Within ``with``: records ``x > 0`` of every ``torch.relu`` call, in
    call order (the conv stacks' and the prenet's activations)."""

    def __enter__(self):
        self.masks, self.real = [], torch.relu
        torch.relu = self
        return self

    def __call__(self, x):
        self.masks.append((x.detach() > 0).cpu())
        return self.real(x)

    def __exit__(self, *exc):
        torch.relu = self.real


def relu_flips(a, b):
    """(total, [(call, shape, count)]) of the relu masks that differ."""
    where = [(i, tuple(x.shape), int((x != y).sum())) for i, (x, y) in
             enumerate(zip(a.masks, b.masks)) if (x != y).any()]
    return sum(n for _, _, n in where), where


def network_grads(model, state, batch, cotangents=None):
    """(grads by leaf path, loss, cotangents): the gradient of the
    training loss (``drop_rate`` 0) through the network for the given
    cotangents of (mel_outputs, linear_outputs), by default the loss's own
    on this device; handing one computation's cotangents to another holds
    the rest of the backward without the L1 losses' sign flips."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
    out, _ = model.forward_train(params, state.bn_state, batch.inputs,
                                 batch.input_lengths, batch.speaker_ids,
                                 batch.mel_targets)
    heads = [out["mel_outputs"], out["linear_outputs"]]
    # the loss's partial derivatives in the outputs (linear_outputs also
    # depend on mel_outputs: the VJP below adds that path)
    leaves = [h.detach().requires_grad_(True) for h in heads]
    loss, _ = model.loss({"mel_outputs": leaves[0], "linear_outputs": leaves[1],
                          "alignments": out["alignments"].detach()},
                         batch.mel_targets, batch.linear_targets)
    if cotangents is None:
        cotangents = torch.autograd.grad(loss, leaves)
    named = named_leaves(params)
    grads = torch.autograd.grad(
        heads, [p for _, p in named],
        grad_outputs=[c.to(h.device, h.dtype) for c, h in zip(cotangents, heads)],
        allow_unused=True)
    return ({path: torch.zeros_like(p) if g is None else g
             for (path, p), g in zip(named, grads)}, loss.item(), cotangents)


def gradient_errors(items) -> None:
    """Card against CPU on batches of 4 at the published widths, no
    dropout, float32 and float64, per leaf, with the relu masks that
    differ; then one ``step_fn`` (clip, Adam, EMA) on each device from the
    same state."""
    grads = network_grads
    cfg = load_config("taco2").parse("batch_size=4,batch_group_size=1,drop_rate=0.0")
    model = Tacotron2(cfg)
    opt, sched = make_optimizer(cfg, "taco2")
    ema = cfg.ema_decay > 0
    step = build_tacotron_train_step(model, opt, sched, cfg.ema_decay)
    cases = [("corpus 0-3", 0, next(DataFeeder(items[:4], cfg).epoch_batches(0))),
             ("corpus 0-3", 1, next(DataFeeder(items[:4], cfg).epoch_batches(0))),
             ("corpus 4-7", 0, next(DataFeeder(items[4:8], cfg).epoch_batches(0)))]
    cases += [(f"random {s}", 0, chip_smoke.random_batch(s)) for s in range(6)]
    for name, seed, batch in cases:
        state = {d: create_state(model, opt, seed, ema=ema, device=d)
                 for d in ("cpu", "cuda")}
        data = {d: batch_to_device(batch, d) for d in ("cpu", "cuda")}
        torch.set_default_dtype(torch.float64)   # the decoder's zero carries too
        try:
            s64, b64 = chip_smoke.to_float64(state["cpu"], data["cpu"])
            with ReluMasks() as m64:
                ref, loss64, cot64 = grads(model, s64, b64)
            s64, b64 = chip_smoke.to_float64(state["cuda"], data["cuda"])
            card64 = grads(model, s64, b64, cot64)[0]
            card64_own = grads(model, s64, b64)[0]
        finally:
            torch.set_default_dtype(torch.float32)
        with ReluMasks() as m_cpu:
            cpu, loss_cpu, cot_cpu = grads(model, state["cpu"], data["cpu"])
        with ReluMasks() as m_card:
            own, loss_gpu, cot_gpu = grads(model, state["cuda"], data["cuda"])
        shared = grads(model, state["cuda"], data["cuda"], cot_cpu)[0]
        cpu_t = grads(model, state["cpu"], data["cpu"], cot64)[0]
        card_t = grads(model, state["cuda"], data["cuda"], cot64)[0]
        cols = {"card|cpu cot": chip_smoke.leaf_gaps(cpu, shared), "card own": chip_smoke.leaf_gaps(cpu, own),
                "cpu32-64": chip_smoke.leaf_gaps(ref, cpu_t), "card32-64": chip_smoke.leaf_gaps(ref, card_t),
                "card64-64": chip_smoke.leaf_gaps(ref, card64)}
        flips = [sum(int((a.cpu().sign() != b.cpu().sign()).sum())
                     for a, b in zip(x, y)) for x, y in
                 ((cot_cpu, cot_gpu), (cot_cpu, cot64), (cot_gpu, cot64))]
        n_cot = sum(c.numel() for c in cot64)
        print(f"{name}, init seed {seed}, T_out {batch.mel_targets.shape[1]}: loss "
              f"float64 {loss64:.9f}, cpu {loss_cpu:.9f}, card {loss_gpu:.9f}; L1 signs "
              f"flipped of {n_cot}: card/cpu {flips[0]}, cpu/f64 {flips[1]}, "
              f"card/f64 {flips[2]}")
        n_relu = sum(x.numel() for x in m64.masks)
        for label, a, b in (("card/cpu", m_cpu, m_card), ("cpu/f64", m64, m_cpu),
                            ("card/f64", m64, m_card)):
            total, where = relu_flips(a, b)
            print(f"  relu masks {label}: {total} of {n_relu} differ, at (call, shape, "
                  f"count) {where[:8]}")
        print(f"  float64 card own vs cpu: worst leaf "
              f"{max(chip_smoke.leaf_gaps(ref, card64_own).values()):.2e}; whole gradient, "
              f"2-norm of the error over the gradient's: card own/cpu "
              f"{chip_smoke.rel_err(cpu, own):.2e}, cpu32/f64 {chip_smoke.rel_err(ref, cpu_t):.2e}, "
              f"card32/f64 {chip_smoke.rel_err(ref, card_t):.2e}")
        print("  worst leaf per column: " + "; ".join(
            f"{c} {max(v.values()):.2e} ({max(v, key=v.get)})" for c, v in cols.items()))
        first = cols["card|cpu cot"]
        for path in sorted(first, key=first.get, reverse=True)[:4]:
            print(f"  {path:44s} max|g| {ref[path].abs().max().item():.3e}  " + "  ".join(
                f"{c} {v[path]:.2e}" for c, v in cols.items()))
        out = {}
        for d in ("cpu", "cuda"):
            new, m = step(state[d], data[d], None)
            upd = torch.sqrt(sum(torch.sum((a - b).double() ** 2) for a, b in zip(
                tree_leaves(new.params), tree_leaves(state[d].params))))
            out[d] = (float(m["loss"]), float(m["grad_norm"]), float(upd))
        (lc, nc, uc), (lg, ng, ug) = out["cpu"], out["cuda"]
        print(f"  step_fn: loss rel {abs(lg - lc) / lc:.2e}, grad_norm {nc:.6e} vs "
              f"{ng:.6e} (rel {abs(ng - nc) / nc:.2e}), update norm rel "
              f"{abs(ug - uc) / uc:.2e}")


def print_profile(step, state, data, step_ms: float, log_dir: str,
                  tables: bool = True) -> dict:
    """One ``step(state, data)`` under ``torch.profiler``: device time and
    host time by operation, launches, the kernel time's share of
    ``step_ms``, the step's unprofiled wall time (the profiler's own
    start-up stretches the profiled step's wall time), and the share of
    the kernel time spent in ``aten::add_`` (autograd accumulating
    gradients, the optimizer's and the EMA's adds) with its 5 costliest
    input shapes. Returns those numbers; ``tables=False`` prints the
    summary lines alone."""
    from nspeech_tpu_torch.utils import profiling

    with profiling.trace(log_dir, record_shapes=True) as prof:
        state, m = step(state, data, step_generator("cuda", 0, 3))
        float(m["loss"])
        torch.cuda.synchronize()
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    add = next((e for e in ka if e.key == "aten::add_"), None)
    add_ms = 0.0 if add is None else add.device_time_total / 1e3
    out = {"busy_ms": busy, "step_ms": step_ms, "add_ms": add_ms,
           "launches": sum(e.count for e in kernels),
           "add_calls": 0 if add is None else add.count}
    print(f"device busy {busy:.1f} ms (sum of kernel times) in the profiled "
          f"step, {busy / step_ms:.1%} of the unprofiled {step_ms:.1f} ms; kernel "
          f"launches {out['launches']}; aten::add_ {add_ms:.1f} ms of device "
          f"time in {out['add_calls']} calls, {add_ms / max(busy, 1e-9):.1%} of "
          f"the kernel time")
    rows = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                   if e.key == "aten::add_"), key=lambda e: -e.device_time_total)
    out["add_by_shape"] = [(e.input_shapes[0], e.count, e.device_time_total / 1e3)
                           for e in rows[:5]]
    print("aten::add_ by input shape: " + "; ".join(
        f"{shape} x{n}: {ms:.1f} ms" for shape, n, ms in out["add_by_shape"]))
    if tables:
        print(ka.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=50))
        print(ka.table(sort_by="cpu_time_total", row_limit=12,
                       max_name_column_width=50))
        print(f"trace {log_dir}: the 15 costliest device operations")
        profiling.print_trace_summary(log_dir, 15)
    return out


def wavenet_gradient_errors(corpus, n_windows: int = 8) -> None:
    from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder
    from nspeech_tpu_torch.models.wavenet import WaveNet
    from nspeech_tpu_torch.ops.upsample import batch_lc

    cfg = chip_smoke.wavenet_cfg(
        f",batch_size=1,sample_size={chip_smoke.WN_CHECK_WINDOW},"
        "gc_category_cardinality=1")
    net = WaveNet(cfg)
    stream = WaveNetFeeder({"ljspeech": corpus}, net.receptive_field, cfg).batches()
    for i in range(n_windows):
        batch = next(stream)
        masks = {}
        for dev in ("cpu", "cuda"):
            params = create_state(net, make_optimizer(cfg, "wavenet")[0], 0,
                                  device=dev).params
            data = wavenet_batch_to_device(batch, dev)
            with torch.no_grad(), ReluMasks() as m:
                net.forward_train(params, data.audio, data.speaker_ids,
                                  batch_lc(data, cfg))
            masks[dev] = m
        total, _ = relu_flips(masks["cpu"], masks["cuda"])
        n_relu = sum(x.numel() for x in masks["cpu"].masks)
        good, line = chip_smoke.wavenet_agreement(chip_smoke.wavenet_card_vs_cpu(batch))
        print(f"window {i}: post-net relu masks card/cpu {total} of {n_relu} differ; "
              f"{line} -> {'within' if good else 'OUTSIDE'} the smoke's tolerances")


def profile_wavenet(corpus, extra: str, trace_dir: str) -> None:
    from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder
    from nspeech_tpu_torch.models.wavenet import WaveNet

    cfg = chip_smoke.wavenet_cfg(",gc_category_cardinality=1"
                                 + ("," + extra if extra else ""))
    net = WaveNet(cfg)
    opt, sched = make_optimizer(cfg, "wavenet")
    step = build_wavenet_train_step(net, opt, cfg, sched, use_gc=True, use_lc=True)
    state = create_state(net, opt, 0, device="cuda")
    batch = next(WaveNetFeeder({"ljspeech": corpus}, net.receptive_field,
                               cfg).batches())
    data = wavenet_batch_to_device(batch, "cuda")
    for i in range(2):
        state, m = step(state, data)
        float(m["loss"])
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    print(f"wavenet step ({cfg.compute_dtype}) at batch {cfg.batch_size}, windows of "
          f"{data.audio.shape[1]} samples: {', '.join(f'{t * 1e3:.1f}' for t in times)} "
          f"ms (5 warm steps); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print_profile(step, state, data, sorted(times)[2] * 1e3, trace_dir)


def profile_step(corpus, extra: str, trace_dir: str, deferred_dw: bool = True,
                 tables: bool = True, cache_dir=None, t_out=None) -> dict:
    """The Tacotron-2 step at batch 32 on the corpus's longest batch, or
    its first batch padded to ``t_out`` frames (its features cached in
    ``cache_dir`` when given), with the loops' weight gradients deferred
    (the default) or all from autograd: its wall time after two warm-up
    steps, its peak memory, then :func:`print_profile` of it (its Chrome
    trace into ``trace_dir``; None writes none); returns the profile's
    numbers with ``peak_gib``."""
    cfg = load_config("taco2").parse(extra)
    batches = list(DataFeeder({"ljspeech": corpus}, cfg, seed=0,
                              cache_dir=cache_dir).epoch_batches(0))
    longest = (max(batches, key=lambda b: b.mel_targets.shape[1]) if t_out is None
               else next(b for b in batches if b.mel_targets.shape[1] == t_out))
    model = Tacotron2(cfg)
    opt, sched = make_optimizer(cfg, "taco2")
    state = create_state(model, opt, 0, device="cuda")
    step = build_tacotron_train_step(model, opt, sched, deferred_dw=deferred_dw)
    data = batch_to_device(longest, "cuda")
    for i in range(2):
        state, m = step(state, data, step_generator("cuda", 0, i))
        float(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, data, step_generator("cuda", 0, 2))
    float(m["loss"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"step ({cfg.compute_dtype}, weight gradients "
          f"{'deferred' if deferred_dw else 'by autograd'}) at batch "
          f"{data.mel_targets.shape[0]}, T_in {data.inputs.shape[1]}, T_out "
          f"{data.mel_targets.shape[1]}: {wall * 1e3:.1f} ms, peak memory "
          f"{peak:.2f} GiB")
    out = print_profile(step, state, data, wall * 1e3, trace_dir, tables)
    out["peak_gib"] = peak
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="taco2", choices=["taco2", "wavenet"])
    parser.add_argument("--hparams", default="",
                        help="k=v,... for the profiled step (e.g. "
                             "compute_dtype=bfloat16)")
    parser.add_argument("--profile-only", action="store_true",
                        help="skip the card-against-CPU comparison")
    parser.add_argument("--no-deferred", action="store_true",
                        help="Tacotron-2: profile the step with every weight "
                             "gradient from autograd (deferred_dw=False)")
    parser.add_argument("--trace-dir", default=os.path.join("build", "profile"),
                        help="where the profiled step's Chrome trace goes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card", file=sys.stderr)
        return 1
    from nspeech_tpu_torch.ops.policy import set_matmul_precision

    set_matmul_precision("highest")
    print(chip_smoke.card_line())
    with tempfile.TemporaryDirectory() as tmp:
        corpus = chip_smoke.write_corpus(os.path.join(tmp, "corpus"))
        if args.model == "wavenet":
            if not args.profile_only:
                wavenet_gradient_errors(corpus)
            profile_wavenet(corpus, args.hparams, args.trace_dir)
            return 0
        if not args.profile_only:
            gradient_errors(load_items({"ljspeech": corpus}))
        profile_step(corpus, args.hparams, args.trace_dir,
                     deferred_dw=not args.no_deferred)
    return 0


if __name__ == "__main__":
    sys.exit(main())
