"""Time the PyTorch port's WaveNet sampler kernel from one checkout.

    python3 scripts/torch_sampler_ab.py [--stamps] [ROOT]

Imports ``nspeech_tpu_torch`` from the checkout at ROOT (default: the one
holding this script), builds its sampler kernel (``csrc/wavenet_gen.cu``)
and times it at full vocoder width (wavenet hparams + lc_channels=80,
gc_channels=16, gc_category_cardinality=4, seeded weights and
conditioning, temperature 1): one-shot launches of N samples at batch 1
(K1) and at batch 4 with one speaker per stream (K2), and a primed launch
(K3) of a full receptive field of seed codes with one kept sample, whose
time is almost all priming steps. Each time is the mean over REPS
launches, timed with CUDA events after one warm-up launch. Prints the
ptxas register report and one JSON line with the times and the card's
name and power limit. Needs one CUDA card.

``--stamps`` also builds the kernel with ``-DWAVENET_STAMPS`` and runs one
B=1 launch of N samples with it: rank 0 of the stream writes
``%globaltimer`` stamps at six points of each of the first 64 steps (step
start, chain end, after each of the three cluster barriers, the code) and
``clock64`` stamps in its middle layer; rank 1 writes ``clock64`` stamps
in the head. The JSON line then carries the mean microseconds of each
phase over steps 1-62: the chain (causal tap, L layers), the first
cluster barrier (the head ranks finish their skip columns), post1, post2
with the argmax, rank 0's reduction of the candidates, and the tail up to
the next step's start; the mean SM cycles of the middle layer's
parts: the gates (a gate warp), the residual update (a dense warp, beside
the gates), and the whole layer up to its block barrier; and of the
head's parts on rank 1 (its skip columns during the chain, the wait for
the first cluster barrier, its post1 columns, their all-gather and
barrier, its post2 columns).

To compare two checkouts, run the script for each in turns in one call on
one card (A, B, B, A): times from different calls may come from cards
with other power limits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

N = 2000
REPS = 5
PHASES = ("chain", "barrier_A", "post1", "post2_argmax", "reduce", "tail")
LAYER_PARTS = {"gates": (6, 8), "dense": (11, 10), "layer": (6, 9)}
HEAD_PARTS = {"skip_during_chain": (12, 13), "wait_barrier_A": (13, 14),
              "post1": (14, 17), "gather_and_barrier_B": (17, 15),
              "post2": (15, 16)}   # rank 1: (from mark, to mark), SM cycles


def timed(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_means(stamps) -> dict:
    """From a [steps, marks] array of stamps: the mean microseconds of each
    phase of a step over steps 1 .. len - 2 (%globaltimer, marks 0-5; step
    0 pays the launch's cold caches) and the mean SM cycles of the parts of
    the middle layer and of the head (clock64, marks 6 on; each part is
    timed on one SM)."""
    import numpy as np

    s = np.asarray(stamps, dtype=np.float64)
    marks = np.concatenate([s[:-1, :6], s[1:, :1]], axis=1)[1:]  # + next start
    out = {name: float(np.diff(marks, axis=1)[:, i].mean() / 1e3)
           for i, name in enumerate(PHASES)}
    out["step"] = float((marks[:, -1] - marks[:, 0]).mean() / 1e3)
    for key, parts in (("middle_layer_cycles", LAYER_PARTS),
                       ("head_cycles", HEAD_PARTS)):
        out[key] = {name: float((s[1:-1, j] - s[1:-1, i]).mean())
                    for name, (i, j) in parts.items()}
    return out


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--stamps"]
    stamps = "--stamps" in sys.argv[1:]
    root = os.path.abspath(args[0] if args else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.wavenet import WaveNet
    from nspeech_tpu_torch.ops.cuda import build, wavenet_gen
    from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
    from nspeech_tpu_torch.ops.layers import tree_to
    from nspeech_tpu_torch.ops.upsample import upsample_on_device

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    _, report = build.build("wavenet_gen.cu")
    for line in report.splitlines():
        if "registers" in line:
            print("ptxas:", line.strip())
    net = WaveNet(load_config("wavenet").parse(
        "lc_channels=80,gc_channels=16,gc_category_cardinality=4"))
    params = tree_to(net.init(0), "cuda")
    out = {"root": root, "card": card, "samples": N}

    def conditioning(batch, n):
        mel = np.random.default_rng(batch).random((batch, n // 250 + 1, 80))
        return upsample_on_device(torch.tensor(mel, dtype=torch.float32,
                                               device="cuda"), 250, n)

    for batch, gc in ((1, None), (4, [0, 1, 2, 3])):
        lc = conditioning(batch, N)
        gen = CudaWaveNetGenerator(net, params, gc_ids=gc)
        out[f"ms_B{batch}"] = timed(
            lambda: gen(N, seed=1, batch=batch, lc=lc, temperature=1.0), REPS)
        out[f"us_per_sample_B{batch}"] = out[f"ms_B{batch}"] * 1e3 / N
    # priming: a receptive field of seed codes, one kept sample
    P = net.receptive_field
    gen = CudaWaveNetGenerator(net, params)
    lc = conditioning(1, P + 1)
    seeds = torch.randint(0, net.quantization_channels, (1, P),
                          dtype=torch.int32, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    out["ms_primed_P"] = timed(
        lambda: gen(1, seed=1, seed_codes=seeds, lc=lc, temperature=1.0), REPS)
    out["prime_len"] = P
    out["us_per_priming_step"] = out["ms_primed_P"] * 1e3 / P
    sampler = wavenet_gen.SAMPLER
    if hasattr(sampler, "max_active_clusters"):
        out["max_active_clusters"] = sampler.max_active_clusters(gen.packed)
    if stamps:
        stamped = wavenet_gen.WaveNetSampler(stamps=True)
        buf = torch.zeros(wavenet_gen.STAMP_STEPS, wavenet_gen.STAMP_MARKS,
                          dtype=torch.int64, device="cuda")
        lc = conditioning(1, N)
        for _ in range(2):       # the second launch runs on warm caches
            _, code, prev, rings = gen.chunk_carry0(1)
            state = torch.stack([code, prev], dim=1).contiguous()
            stamped(gen.packed, lc, N, 1, 1.0, 1, rings, state, 0, stamps=buf)
        torch.cuda.synchronize()
        out["stamps_us"] = phase_means(buf.cpu().numpy())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
