"""Time the PyTorch port's WaveNet sampler kernel from one checkout.

    python3 scripts/torch_sampler_ab.py [ROOT]

Imports ``nspeech_tpu_torch`` from the checkout at ROOT (default: the one
holding this script), builds its sampler kernel (``csrc/wavenet_gen.cu``)
and times one-shot launches of N samples at full vocoder width (wavenet
hparams + lc_channels=80, gc_channels=16, gc_category_cardinality=4,
seeded weights and conditioning, temperature 1): batch 1, and batch 4 with
one speaker per stream. Each time is the mean over REPS launches, timed
with CUDA events after one warm-up launch. Prints the ptxas register
report and one JSON line with the times and the card's name and power
limit. Needs one CUDA card.

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


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.wavenet import WaveNet
    from nspeech_tpu_torch.ops.cuda import build
    from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
    from nspeech_tpu_torch.ops.layers import tree_to
    from nspeech_tpu_torch.ops.upsample import upsample_on_device

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
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
    for batch, gc in ((1, None), (4, [0, 1, 2, 3])):
        mel = np.random.default_rng(batch).random((batch, N // 250 + 1, 80))
        lc = upsample_on_device(torch.tensor(mel, dtype=torch.float32,
                                             device="cuda"), 250, N)
        gen = CudaWaveNetGenerator(net, params, gc_ids=gc)
        gen(N, seed=1, batch=batch, lc=lc, temperature=1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            gen(N, seed=1, batch=batch, lc=lc, temperature=1.0)
        end.record()
        torch.cuda.synchronize()
        out[f"ms_B{batch}"] = start.elapsed_time(end) / REPS
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
